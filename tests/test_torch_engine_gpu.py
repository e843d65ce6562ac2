"""The engine's CUDA graphs on the card, against the same engine run
eagerly (``repro_torch.workloads.decode.graphs = False``), at reduced
configs in the models' bf16.  Marked ``gpu``: each test skips without a
CUDA device (decided in the fixture).  Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_engine_gpu.py

A graph replays the kernels the eager step launches, with the same
arguments, so the streams are held equal token for token.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.dse import DesignPoint  # noqa: E402
from repro_torch.kernels.ragged_decode import ops as rd  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads import decode as D  # noqa: E402
from repro_torch.workloads import DecodeEngine, SSMEngine, ServeConfig  # noqa: E402
from repro_torch.workloads.compile_cache import GraphStep  # noqa: E402

ARCHS = ("minitron-4b", "qwen2.5-32b", "falcon-mamba-7b")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run only on the GPU")
    return torch.device("cuda")


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        model = Model(get_reduced(arch), "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        cls = SSMEngine if arch == "falcon-mamba-7b" else DecodeEngine
        _MODELS[arch] = (model, params, cls)
    return _MODELS[arch]


def _engine(arch, graphs, monkeypatch, **kw):
    model, params, cls = _model(arch)
    monkeypatch.setattr(D, "graphs", graphs)
    cfg = dict(max_slots=3, max_len=128, eos_id=-1, kv_page_rows=8)
    cfg.update(kw)
    return cls(model, params, ServeConfig(**cfg))


def _serve(eng, n=5, new=40, seed=0, hook=None):
    rng = np.random.default_rng(seed)
    rids = [eng.submit(rng.integers(1, 200, size=int(rng.integers(3, 40))),
                       max_new_tokens=new) for _ in range(n)]
    steps = 0
    while eng.has_work:
        if hook is not None:
            hook(eng, steps)
        eng.step()
        steps += 1
        assert steps < 1000
    res = eng.results()
    return [res[r] for r in rids]


def _graphs_of(eng):
    return [e for e in eng._exec._exe.values() if isinstance(e, GraphStep)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_streams_equal_eager(cuda, arch, monkeypatch):
    """warm_compile captures ahead; serving then captures nothing more
    (growth past the warm bounds dispatches a covering one), and the
    streams equal the eager engine's."""
    streams = []
    for graphs in (True, False):
        eng = _engine(arch, graphs, monkeypatch)
        eng.warm_compile(None)
        warmed = eng.graph_captures
        streams.append(_serve(eng))
        assert eng.graph_captures == warmed
        assert (warmed >= 1) == graphs
        assert bool(_graphs_of(eng)) == graphs
    assert streams[0] == streams[1]
    assert all(len(s) == 40 for s in streams[0])


@pytest.mark.gpu
def test_graph_launches_count_replays(cuda, monkeypatch):
    """A replay adds the launches its capture recorded: the ragged decode
    counter reads layers x decode steps after a graph run."""
    eng = _engine("minitron-4b", True, monkeypatch)
    eng.warm_compile(None)
    before = rd.launches
    _serve(eng, n=2, new=10)
    steps = eng._obs.registry.histogram_at("decode_step_s").count
    layers = eng.model.cfg.num_layers
    assert rd.launches - before == layers * steps
    replays = sum(g.replays for g in _graphs_of(eng))
    assert replays == steps
    assert all(g.launches == {"ragged_decode": layers}
               for g in _graphs_of(eng))


@pytest.mark.gpu
def test_tickets_zero_after_many_replays(cuda, monkeypatch):
    eng = _engine("minitron-4b", True, monkeypatch)
    eng.warm_compile(None)
    _serve(eng, n=3, new=12)
    for g in _graphs_of(eng):
        for _ in range(100):
            g()
    torch.cuda.synchronize()
    bufs = [g.tickets for g in _graphs_of(eng)]
    assert bufs and all(int(b.abs().sum()) == 0 for b in bufs)
    assert all(int(b.abs().sum()) == 0 for b in rd._tickets.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("minitron-4b", "falcon-mamba-7b"))
def test_resize_recaptures_and_drops_the_old_pool(cuda, arch, monkeypatch):
    """apply(slots) mid-stream builds a new pool: its steps are captured
    anew, the old pool's graphs leave the cache, and the streams equal
    the eager engine's under the same applies."""
    def hook(eng, steps):
        if steps in (3, 9):
            old = eng._pool.gen
            got = eng.apply(None, DesignPoint(cus=0,
                                              slots=6 if steps == 3 else 4))
            if steps == 3:
                assert got == {"slots": 6} and eng._pool.gen != old
            if eng._pool.gen != old:
                assert not any(k[2] == old for k in eng._exec._exe)

    streams, captures = [], []
    for graphs in (True, False):
        eng = _engine(arch, graphs, monkeypatch)
        streams.append(_serve(eng, n=7, new=24, hook=hook))
        captures.append(eng.graph_captures)
    assert streams[0] == streams[1]
    # the first pool's step, then at least the grown pool's
    assert captures[0] >= 2 and captures[1] == 0
    assert len(streams[0]) == 7 and all(len(s) == 24 for s in streams[0])


@pytest.mark.gpu
def test_warm_compile_from_a_thread_while_serving(cuda, monkeypatch):
    """A second thread warms (captures) while the serving loop steps;
    the engine's device lock orders the two, and the streams equal the
    eager engine's."""
    eng = _engine("minitron-4b", True, monkeypatch, max_len=256)
    stop = threading.Event()
    errors = []

    def warm():
        try:
            while not stop.is_set():
                eng.warm_compile(None)
                eng.warm_compile(None, DesignPoint(cus=0, slots=5))
                time.sleep(0.005)    # let the serving loop take the lock
        except Exception as exc:     # surfaced by the assert below
            errors.append(exc)

    t = threading.Thread(target=warm)
    t.start()
    try:
        got = _serve(eng, n=6, new=60)
    finally:
        stop.set()
        t.join(timeout=120)
    assert not errors and not t.is_alive()
    assert eng.graph_captures >= 2
    want = _serve(_engine("minitron-4b", False, monkeypatch, max_len=256),
                  n=6, new=60)
    assert got == want


@pytest.mark.gpu
def test_sanitized_graph_run_is_bit_identical(cuda, monkeypatch):
    """REPRO_SANITIZE=1 arms torch's sync debug mode for each step; the
    designed reads (first tokens, harvests, the exports and restores of
    preemption) pass through, and the tokens do not change."""
    kw = dict(max_len=64, kv_page_rows=4, kv_arena_frac=0.5)
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    plain_eng = _engine("minitron-4b", True, monkeypatch, **kw)
    plain = _serve(plain_eng, n=5, new=20)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    san_eng = _engine("minitron-4b", True, monkeypatch, **kw)
    san = _serve(san_eng, n=5, new=20)
    assert san == plain
    assert san_eng.preempt_count == plain_eng.preempt_count >= 1
    assert torch.cuda.get_sync_debug_mode() == 0

    class Bad(DecodeEngine):
        def _step_dispatch(self):
            super()._step_dispatch()
            self.cache["pos"].sum().item()   # an implicit read

    model, params, _ = _model("minitron-4b")
    bad = Bad(model, params, ServeConfig(max_slots=2, max_len=64))
    bad.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="synchroniz"):
        bad.step()
    assert torch.cuda.get_sync_debug_mode() == 0
