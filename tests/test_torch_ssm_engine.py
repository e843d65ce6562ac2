"""Port parity for the SSM serving engine: ``repro_torch``'s ``SSMEngine``
against the JAX ``SSMEngine`` on falcon-mamba-reduced with the same
weights (fp32 activations), greedy streams equal request by request, for
prompts of mixed lengths (some past ``max_len``: admission is slot-bound),
through preemption and exact resume; the slot-bound arena, the rejection
of archs with a KV cache, the workload class and the launcher.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads import SSMEngine as JaxSSMEngine  # noqa: E402
from repro.workloads import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads import (DECODE, SSM, DecodeEngine,  # noqa: E402
                                   SSMEngine, ServeConfig, workload_class_of)

_MODELS = {}


def _models():
    if not _MODELS:
        jcfg = dataclasses.replace(jax_get_reduced("falcon-mamba-7b"),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_reduced("falcon-mamba-7b"),
                                   dtype="float32")
        jm = jax_build_model(jcfg)
        jp = strip(jm.init(jax.random.key(2)))
        tm = Model(tcfg, "cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS.update(jm=jm, jp=jp, tm=tm, tp=tp)
    return _MODELS["jm"], _MODELS["jp"], _MODELS["tm"], _MODELS["tp"]


# prompt lengths: the shortest the conv window takes (3), odd ones, and
# two past max_len = 16
PLENS = (3, 9, 21, 5, 40, 12)


def _drive(eng, new, preempt_at=()):
    rng = np.random.default_rng(0)
    for n in PLENS:
        eng.submit(rng.integers(1, 256, size=n), max_new_tokens=new)
    steps = 0
    while eng.has_work:
        if steps in preempt_at:
            eng.preempt_one()
        eng.step()
        steps += 1
        assert steps < 500
    assert eng.arena.used == 0
    return eng.results()


@pytest.mark.parametrize("pipeline,use_kernels", [(True, True),
                                                  (False, True),
                                                  (True, False)])
def test_streams_match_reference(pipeline, use_kernels):
    jm, jp, tm, tp = _models()
    kw = dict(max_slots=3, max_len=16, eos_id=-1, pipeline_decode=pipeline,
              use_kernels=use_kernels)
    want = _drive(JaxSSMEngine(jm, jp, JaxServeConfig(**kw)), 8)
    got = _drive(SSMEngine(tm, tp, ServeConfig(**kw)), 8)
    assert got == want
    assert len(got) == len(PLENS) and all(len(t) == 8 for t in got.values())


def test_preemption_resumes_exactly():
    """A preempted request parks its state block host-side and resumes
    from it: streams equal an undisturbed run and the JAX engine under the
    same preemption schedule."""
    jm, jp, tm, tp = _models()
    kw = dict(max_slots=2, max_len=16, eos_id=-1)
    undisturbed = _drive(SSMEngine(tm, tp, ServeConfig(**kw)), 7)
    eng = SSMEngine(tm, tp, ServeConfig(**kw))
    got = _drive(eng, 7, preempt_at=(2, 5))
    want = _drive(JaxSSMEngine(jm, jp, JaxServeConfig(**kw)), 7,
                  preempt_at=(2, 5))
    assert eng.preempt_count == 2
    assert got == undisturbed == want


def test_arena_is_slot_bound():
    """Capacity is slots x one state, whatever max_len; a full slot pool
    holds a request back until a slot frees."""
    _, _, tm, tp = _models()
    cfg = tm.cfg
    state = TS.state_elems(cfg) * cfg.num_layers
    for paged in (True, False):
        a = SSMEngine(tm, tp, ServeConfig(max_slots=2, max_len=16,
                                          paged_kv=paged, eos_id=-1))
        b = SSMEngine(tm, tp, ServeConfig(max_slots=2, max_len=4096,
                                          paged_kv=paged, eos_id=-1))
        assert a.arena.capacity == b.arena.capacity == 2 * state
    eng = SSMEngine(tm, tp, ServeConfig(max_slots=2, max_len=16, eos_id=-1))
    for n in (30, 4, 50):
        eng.submit(np.arange(1, n + 1) % 256, max_new_tokens=3)
    eng.step()
    assert eng.active_count == 2 and eng.queue_depth == 1
    out = eng.run_to_completion()
    assert sorted(len(t) for t in out.values()) == [3, 3, 3]
    assert eng.arena.utilization() == 0.0


def test_rejects_kv_archs_and_kv_engine_rejects_long_prompts():
    _, _, tm, tp = _models()
    mcfg = dataclasses.replace(get_reduced("minitron-4b"), dtype="float32")
    mm = Model(mcfg, "cpu")
    with pytest.raises(ValueError, match="attention-free"):
        SSMEngine(mm, mm.init(torch.Generator().manual_seed(0)), ServeConfig())
    # the same long request on the transformer engine is rejected but
    # recorded: it would overflow a KV slot
    dec = DecodeEngine(tm, tp, ServeConfig(max_slots=2, max_len=16,
                                           eos_id=-1))
    rid = dec.submit(np.arange(1, 40), max_new_tokens=5)
    assert dec.run_to_completion()[rid] == []


def test_workload_class_and_launcher():
    _, _, tm, _ = _models()
    assert workload_class_of(tm.cfg) == SSM
    assert workload_class_of(get_reduced("minitron-4b")) == DECODE
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = serve.main(["--arch", "falcon-mamba-7b", "--reduced",
                         "--device", "cpu", "--requests", "3",
                         "--max-new-tokens", "4"])
    stats = json.loads(buf.getvalue())
    assert rc == 0 and stats["workload_class"] == SSM
    # step() reports decoded tokens; each prefill's first token is not one
    assert stats["tokens_emitted"] == 3 * 3 and stats["device"] == "cpu"
