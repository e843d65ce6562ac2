"""Port parity for the serving engine: ``repro_torch``'s ``DecodeEngine``
against the JAX ``DecodeEngine`` on the same requests and the same
weights (fp32 activations), through paged admission with an arena small
enough to force preemption and resume.  Greedy token streams must be
equal, request by request.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads.decode import DecodeEngine as JaxEngine  # noqa: E402
from repro.workloads.decode import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads.decode import DecodeEngine, ServeConfig  # noqa: E402

_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jax_get_reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.key(1))
        tm = Model(tcfg, "cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, strip(jp)), tcfg, "cpu")
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def _drive(eng, n, new, seed, preempt_at=()):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        eng.submit(rng.integers(1, 256, size=int(rng.integers(3, 12))),
                   max_new_tokens=new)
    steps = 0
    while eng.has_work:
        if steps in preempt_at:
            eng.preempt_one()
        eng.step()
        steps += 1
        assert steps < 500
    assert eng.arena.used == 0
    return eng.results()


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_streams_match_reference_through_preemption(arch, pipeline):
    """kv_arena_frac=0.5 oversubscribes the pages, so growth preempts and
    later resumes requests; every stream must equal the reference's."""
    jm, jp, tm, tp = _models(arch)
    kw = dict(max_slots=3, max_len=32, eos_id=-1, paged_kv=True,
              kv_page_rows=4, kv_arena_frac=0.5, pipeline_decode=pipeline,
              use_kernels=True)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = DecodeEngine(tm, tp, ServeConfig(**kw))
    want = _drive(jeng, 6, 12, seed=0)
    got = _drive(teng, 6, 12, seed=0)
    assert teng.preempt_count >= 1
    assert teng.preempt_count == jeng.preempt_count
    assert got == want
    assert all(len(t) == 12 for t in got.values())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_explicit_preemption_and_padded_path_match_reference(use_kernels):
    """An SLO-style preempt_one mid-run, slot-granular (FlexArena)
    admission, and the padded decode path when kernels are off."""
    jm, jp, tm, tp = _models("qwen2.5-32b")
    kw = dict(max_slots=3, max_len=32, eos_id=-1, paged_kv=False,
              use_kernels=use_kernels)
    want = _drive(JaxEngine(jm, jp, JaxServeConfig(**kw)), 5, 6, seed=4,
                  preempt_at=(3,))
    teng = DecodeEngine(tm, tp, ServeConfig(**kw))
    got = _drive(teng, 5, 6, seed=4, preempt_at=(3,))
    assert teng.preempt_count == 1
    assert got == want


def test_engine_bookkeeping():
    """Oversized requests are rejected but recorded; stats and snapshot
    account for every request; eos ends a stream in sync mode."""
    _, _, tm, tp = _models("minitron-4b")
    eng = DecodeEngine(tm, tp, ServeConfig(max_slots=2, max_len=32,
                                           eos_id=-1))
    big = eng.submit(np.arange(1, 31), max_new_tokens=8)
    ok = eng.submit(np.arange(1, 5), max_new_tokens=3)
    assert eng.stats()["queue_depth"] == 2 and eng.pending_tokens() > 0
    snap = eng.run_to_completion()
    assert snap[big] == [] and len(snap[ok]) == 3
    assert eng.stats()["active"] == 0 and eng.arena.utilization() == 0.0
    assert eng.recent_lengths() and eng._obs.registry.histogram_at(
        "prefill_s").count == 1
    spans = {e["name"] for e in eng._obs.tracer.events()}
    assert {"admit", "prefill", "decode_step"} <= spans
    first = snap[ok][0]
    sync = DecodeEngine(tm, tp, ServeConfig(max_slots=2, max_len=32,
                                            eos_id=first))
    rid = sync.submit(np.arange(1, 5), max_new_tokens=3)
    out = sync.run_to_completion()[rid]
    # the prefill's token is not checked against eos; a decoded eos ends
    assert out[0] == first and first not in out[1:-1]
    assert len(out) == 3 or out[-1] == first
