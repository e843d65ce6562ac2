"""The rest of the port's serving engine against the JAX engine, on the
CPU: the executable cache, ``warm_compile`` and the covering-bound
fallback, ``apply(slots)`` grow and shrink mid-stream, ``evacuate`` with
``adopt_request`` / ``adopt_queued`` (parked requests included), the
runtime sanitizer and the ``Engine`` protocol.  Reduced configs in fp32,
the same weights bridged from the JAX init; greedy streams must be equal
request by request.  (On the CPU every cache entry is the eager closure of
a step, under the reference's keys; the CUDA graphs are held to eager
streams by ``tests/test_torch_engine_gpu.py`` on the card.)
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.dse import DesignPoint as JaxDesignPoint  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads import SSMEngine as JaxSSMEngine  # noqa: E402
from repro.workloads.decode import DecodeEngine as JaxEngine  # noqa: E402
from repro.workloads.decode import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.dse import DesignPoint  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads import DecodeEngine, SSMEngine, ServeConfig  # noqa: E402
from repro_torch.workloads.base import (Engine,  # noqa: E402
                                        ImplicitTransferError, build_engine)
from repro_torch.workloads.compile_cache import ExecutableCache  # noqa: E402

ARCHS = ("qwen2.5-32b", "minitron-4b", "falcon-mamba-7b")
_MODELS = {}


def _models(arch):
    """(JAX model, JAX params, port model, port params, JAX engine class,
    port engine class) for ``arch`` reduced, in fp32."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jax_get_reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        jm = jax_build_model(jcfg)
        jp = strip(jm.init(jax.random.key(1)))
        tm = Model(tcfg, "cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        ssm = arch == "falcon-mamba-7b"
        _MODELS[arch] = (jm, jp, tm, tp,
                         JaxSSMEngine if ssm else JaxEngine,
                         SSMEngine if ssm else DecodeEngine)
    return _MODELS[arch]


def _pair(arch, **kw):
    """A JAX engine and a port engine of ``arch`` under the same config."""
    jm, jp, tm, tp, jcls, tcls = _models(arch)
    return (jcls(jm, jp, JaxServeConfig(**kw)),
            tcls(tm, tp, ServeConfig(**kw)))


def _prompts(n, seed, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=int(rng.integers(lo, hi)))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# ExecutableCache
# ---------------------------------------------------------------------------

def test_cache_lru_evicts_at_capacity():
    cache = ExecutableCache(capacity=2)
    cache.get_or_build("a", lambda: "A")
    cache.get_or_build("b", lambda: "B")
    assert cache.get("a") == "A"            # a is now the newest
    cache.get_or_build("c", lambda: "C")    # b, the oldest, goes
    assert cache.contains("a") and cache.contains("c")
    assert not cache.contains("b")
    assert cache.snapshot() == {"builds": 3, "hits": 1, "size": 2,
                                "capacity": 2}


def test_cache_ensure_builds_once_and_evict_drops_matches():
    cache = ExecutableCache()
    calls = []
    build = lambda: calls.append(1) or object()
    assert cache.ensure(("decode", 1, (32,)), build) == 1
    assert cache.ensure(("decode", 1, (32,)), build) == 0
    assert len(calls) == 1 and cache.builds == 1
    cache.ensure(("decode", 2, (32,)), build)
    assert cache.evict(lambda k: k[1] == 1) == 1
    assert not cache.contains(("decode", 1, (32,)))
    assert cache.contains(("decode", 2, (32,)))


def test_cache_racing_threads_get_one_entry():
    """Two threads racing get_or_build on one key: both get an entry, the
    cache holds one, and it counts one build (a lost race costs a
    duplicate build, never a second entry)."""
    cache = ExecutableCache()
    barrier = threading.Barrier(2)
    got = [None, None]

    def build():
        barrier.wait(timeout=10)            # both builds run at once
        return object()

    def run(i):
        got[i] = cache.get_or_build("k", build)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert all(g is not None for g in got)
    assert cache.snapshot()["size"] == 1 and cache.builds == 1
    assert cache.get("k") in got


# ---------------------------------------------------------------------------
# warm_compile and the covering-bound fallback against the reference
# ---------------------------------------------------------------------------

def _warm_sets(eng):
    """Decode bounds and prefill lengths the engine's cache holds."""
    keys = list(eng._exec._exe)
    return ({k[-1] for k in keys if k[0] == "decode"},
            {k[-1] for k in keys if k[0] == "prefill"})


def test_decode_exec_falls_back_to_warm_covering_bound():
    """As tests/test_ragged_decode.py: a cold bound dispatches the warm
    full-capacity step instead of building one on the serving path."""
    jeng, teng = _pair("minitron-4b", max_slots=2, max_len=128, eos_id=-1)
    for eng in (jeng, teng):
        assert eng._covering_bounds((32,)) == [(64,), (96,), (128,)]
        assert eng._next_bounds() == (64,)
    jfull = jeng._decode_exec(jeng.mesh, (128,))
    tfull = teng._decode_exec((128,))
    assert teng._decode_exec((96,)) is tfull
    assert jeng._decode_exec(jeng.mesh, (96,)) is jfull
    assert teng.compile_builds == jeng.compile_builds == 1
    assert teng.covering_steps == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_warm_compile_warms_and_covers_as_reference(arch):
    """The same submits and steps on both engines: warm_compile warms the
    same decode bounds and prefill lengths with the same build count; live
    lengths growing past the warm set then dispatch a covering bound on
    both, building nothing more, and the streams are equal."""
    kw = dict(max_slots=3, max_len=256, eos_id=-1, use_kernels=True)
    jeng, teng = _pair(arch, **kw)
    prompts = _prompts(3, seed=5, lo=20, hi=30)
    built = []
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new_tokens=80)
        for _ in range(3):
            eng.step()
        built.append(eng.warm_compile(None))
    assert built[0] == built[1]
    assert _warm_sets(teng) == _warm_sets(jeng)
    if arch != "falcon-mamba-7b":
        assert built[1] >= 2 and (256,) in _warm_sets(teng)[0]
    for eng in (jeng, teng):
        before = eng.compile_builds
        while eng.has_work:
            eng.step()
        assert eng.compile_builds == before
    assert teng.compile_builds == jeng.compile_builds
    assert teng.results() == jeng.results()
    if arch != "falcon-mamba-7b":
        # lengths past 96 need (128,), never warmed: (256,) covers it
        assert teng.covering_steps > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_warm_compile_covers_candidate_design_point(arch):
    """As tests/test_serve_dse.py: steps warmed for a candidate slot count
    serve after the matching apply without another build."""
    kw = dict(max_slots=2, max_len=32, eos_id=-1)
    jeng, teng = _pair(arch, **kw)
    counts = []
    for eng, point in ((jeng, JaxDesignPoint), (teng, DesignPoint)):
        rng = np.random.default_rng(0)
        eng.submit(rng.integers(1, 256, size=8), max_new_tokens=3)
        eng.run_to_completion(50)
        built = eng.warm_compile(None, point(cus=0, slots=4))
        assert built >= 1
        before = eng.compile_builds
        assert eng.apply(None, point(cus=0, slots=4)) == {"slots": 4}
        eng.submit(rng.integers(1, 256, size=8), max_new_tokens=3)
        eng.run_to_completion(50)
        assert eng.compile_builds == before, \
            "the applied design point built a step warm_compile had built"
        counts.append((built, eng.compile_builds))
    assert counts[0] == counts[1]
    assert teng.design() == {"tp": None, "slots": 4, "buckets": None}


# ---------------------------------------------------------------------------
# apply(slots): grow and shrink mid-stream
# ---------------------------------------------------------------------------

def _drive_apply(eng, point_cls, schedule, prompts, new):
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
    applied, steps = [], 0
    while eng.has_work:
        if steps in schedule:
            live = eng.active_count
            got = eng.apply(None, point_cls(cus=0, slots=schedule[steps]))
            assert got["slots"] == max(schedule[steps], live)
            applied.append((live, got))
        eng.step()
        steps += 1
        assert steps < 500
    assert eng.arena.used == 0
    return eng.results(), applied


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_slots_grow_and_shrink_match_reference(arch):
    """3 slots grow to 5 mid-stream, shrink to 2 (clamped at the live
    count) and grow to 4, with paged admission tight enough to preempt;
    every stream equals the reference's under the same applies at the same
    steps, and the clamps agree."""
    kw = dict(max_slots=3, max_len=32, eos_id=-1, paged_kv=True,
              kv_page_rows=4, kv_arena_frac=0.5)
    jeng, teng = _pair(arch, **kw)
    schedule = {2: 5, 5: 2, 9: 4}
    prompts = _prompts(7, seed=11)
    want, japplied = _drive_apply(jeng, JaxDesignPoint, schedule, prompts, 10)
    got, tapplied = _drive_apply(teng, DesignPoint, schedule, prompts, 10)
    assert tapplied == japplied
    assert got == want
    assert len(got) == 7 and all(len(t) == 10 for t in got.values())
    assert teng.preempt_count == jeng.preempt_count
    assert teng.cfg.max_slots == jeng.cfg.max_slots == 4


def test_resize_evicts_the_old_pool_entries():
    """A resize builds a new pool; the old pool's steps leave the cache,
    so nothing keyed by a freed pool can be dispatched again."""
    _, teng = _pair("minitron-4b", max_slots=2, max_len=32, eos_id=-1)
    teng.submit(np.arange(1, 6), max_new_tokens=8)
    teng.step()
    teng.step()
    old = teng._pool.gen
    assert any(k[2] == old for k in teng._exec._exe)
    teng.apply(None, DesignPoint(cus=0, slots=3))
    assert teng._pool.gen != old
    assert not any(k[2] == old for k in teng._exec._exe)
    assert len(teng.run_to_completion()[0]) == 8


# ---------------------------------------------------------------------------
# evacuate / adopt_request / adopt_queued
# ---------------------------------------------------------------------------

def _evacuate_scenario(make, point_cls, prompts, new):
    """Engine a (3 slots) serves two steps, one request is preempted
    (parked), then a evacuates; engine b (2 slots, the same params)
    adopts the live, parked and queued requests (the third live adoption
    grows b) and serves them to the end.  Returns streams by the order of
    submission."""
    a, b = make(3), make(2)
    rids = [a.submit(p, max_new_tokens=new) for p in prompts]
    a.step()
    a.step()
    assert a.preempt_one() is not None
    live, queued = a.evacuate()
    assert a.arena.used == 0 and a.active_count == 0
    assert a.preempted_depth == 0 and not a.has_work
    assert len(live) == 3 and len(queued) == len(prompts) - 3
    order = {req.rid: req for req, _ in live}
    order.update({req.rid: req for req in queued})
    for req, block in live:
        b.adopt_request(req, block)
    for req in queued:
        b.adopt_queued(req)
    steps = 0
    while b.has_work:
        b.step()
        steps += 1
        assert steps < 500
    assert b.arena.used == 0 and b.cfg.max_slots == 3
    b.results()
    return [list(order[r].out_tokens) for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_evacuate_and_adopt_match_uninterrupted_and_reference(arch):
    jm, jp, tm, tp, jcls, tcls = _models(arch)
    kw = dict(max_len=32, eos_id=-1, paged_kv=True)
    prompts = _prompts(4, seed=7)
    got = _evacuate_scenario(
        lambda n: tcls(tm, tp, ServeConfig(max_slots=n, **kw)),
        DesignPoint, prompts, 9)
    want = _evacuate_scenario(
        lambda n: jcls(jm, jp, JaxServeConfig(max_slots=n, **kw)),
        JaxDesignPoint, prompts, 9)
    plain = tcls(tm, tp, ServeConfig(max_slots=4, **kw))
    rids = [plain.submit(p, max_new_tokens=9) for p in prompts]
    res = plain.run_to_completion()
    assert got == want
    assert got == [res[r] for r in rids]
    assert all(len(t) == 9 for t in got)


def test_export_queued_hands_back_the_queue():
    _, teng = _pair("minitron-4b", max_slots=1, max_len=32, eos_id=-1)
    for p in _prompts(3, seed=1):
        teng.submit(p, max_new_tokens=4)
    teng.step()
    queued = teng.export_queued()
    assert len(queued) == 2 and teng.queue_depth == 0
    assert teng.active_count == 1


# ---------------------------------------------------------------------------
# the runtime sanitizer
# ---------------------------------------------------------------------------

def _sanitized_fleet():
    """A run that preempts and resumes (exports and restores cache blocks
    through the designed explicit reads)."""
    _, _, tm, tp, _, _ = _models("minitron-4b")
    eng = DecodeEngine(tm, tp, ServeConfig(max_slots=3, max_len=32,
                                           eos_id=-1, kv_page_rows=4,
                                           kv_arena_frac=0.5))
    for p in _prompts(5, seed=2):
        eng.submit(p, max_new_tokens=10)
    out = eng.run_to_completion()
    return out, eng.preempt_count


def test_sanitized_run_is_bit_identical(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    plain, n = _sanitized_fleet()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    san, m = _sanitized_fleet()
    assert san == plain and m == n >= 1
    assert torch.Tensor.item.__name__ == "item"     # patches restored


@pytest.mark.parametrize("read", [lambda t: t.item(), int, float, bool])
def test_sanitizer_catches_injected_implicit_read(monkeypatch, read):
    _, _, tm, tp, _, _ = _models("minitron-4b")
    monkeypatch.setenv("REPRO_SANITIZE", "1")

    class Bad(DecodeEngine):
        def _step_dispatch(self):
            super()._step_dispatch()
            read(torch.ones(()))    # implicit read on the hot path

    bad = Bad(tm, tp, ServeConfig(max_slots=2, max_len=32))
    bad.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(ImplicitTransferError, match="implicit"):
        bad.step()
    assert float(torch.ones(())) == 1.0          # guard gone after the step


def test_sanitizer_catches_release_path_bypass(monkeypatch):
    _, _, tm, tp, _, _ = _models("minitron-4b")
    monkeypatch.setenv("REPRO_SANITIZE", "1")

    class Leaky(DecodeEngine):
        def _release_slot(self, slot, req):
            # drop the slot, leak the arena view, never free the slot
            self._active.pop(slot, None)
            req.slot = -1

    leak = Leaky(tm, tp, ServeConfig(max_slots=2, max_len=32))
    leak.submit([1, 2], max_new_tokens=1)
    with pytest.raises(AssertionError, match="slot accounting"):
        for _ in range(6):
            leak.step()


# ---------------------------------------------------------------------------
# the Engine protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wclass,arch", [("decode", "minitron-4b"),
                                         ("ssm", "falcon-mamba-7b")])
def test_engines_satisfy_protocol(wclass, arch):
    _, _, tm, tp, _, tcls = _models(arch)
    eng = build_engine(wclass, tm, tp, ServeConfig(max_slots=2, max_len=32))
    assert type(eng) is tcls
    assert isinstance(eng, Engine)
    stats = eng.stats()
    assert stats["compile_builds"] == 0 and stats["reshard_count"] == 0
    assert stats["design"] == {"tp": None, "slots": 2, "buckets": None}
    with pytest.raises(KeyError):
        build_engine("no-such-class", tm, tp, ServeConfig())
    # any arch serves embeddings: the encoder class is a tenant's choice
    enc = build_engine("encoder", tm, tp, ServeConfig())
    assert enc.workload_class == "encoder" and isinstance(enc, Engine)
    # without a mesh a TP degree is recorded and nothing moves, as the
    # reference's tp_submesh(None, ...)
    assert eng.apply(None, DesignPoint(cus=0, tp=2)) == {"tp": 2}
    assert eng.design()["tp"] == 2 and eng.reshard_count == 0
