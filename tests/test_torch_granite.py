"""Port parity for granite (dense, multi-query attention, plain GELU FFN):
``repro_torch``'s ``Model`` and ``DecodeEngine`` against the JAX package's
on granite-reduced (4 query heads on 1 KV head) and on a narrow variant at
granite's full query group, G = 48 (48 heads on 1 KV head, head dim 16),
with the JAX init's weights carried over by ``params_from_jax``; and the
ragged decode kernel's plain version and split spec, which follow the
CUDA kernel's head groups of at most 8, against the Pallas kernel run in
interpret mode at G = 5, 9 and 48.

fp32: greedy streams equal and logits within 1e-4 of the largest |logit|
(summation order only); engine streams equal the JAX engine's request by
request through paged preemption.  bf16: logits within 3e-2, streams
parting only at near-ties, as ``test_torch_model.py`` holds them.  The
ragged plain versions agree with the Pallas kernel to 1e-5 (fp32).
Admission counts 2 x 1 x 128 x 88 = 22528 KV elements per token for
granite-34b, as the JAX engine counts.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.kernels.ragged_decode import ragged_decode_attention as jax_rd  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads.decode import DecodeEngine as JaxEngine  # noqa: E402
from repro.workloads.decode import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels.ragged_decode import ops as rd  # noqa: E402
from repro_torch.kernels.ragged_decode.ref import (  # noqa: E402
    head_groups, ragged_decode_attention_ref, ragged_decode_split_ref)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads.decode import DecodeEngine, ServeConfig  # noqa: E402

FP32_LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 3e-2
RAGGED_TOL = 1e-5
# granite-reduced, and granite's own query group at a narrow width
VARIANTS = {"reduced": {},
            "g48": dict(num_heads=48, num_kv_heads=1, head_dim=16)}
_MODELS = {}


def _models(variant, dtype="float32"):
    key = (variant, dtype)
    if key not in _MODELS:
        kw = dict(VARIANTS[variant], dtype=dtype)
        jcfg = dataclasses.replace(jax_get_reduced("granite-34b"), **kw)
        tcfg = dataclasses.replace(get_reduced("granite-34b"), **kw)
        jm = jax_build_model(jcfg)
        jp = strip(jm.init(jax.random.key(2)))
        tm = Model(tcfg, "cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run(variant, dtype, *, use_kernels, steps, tol, exact_streams):
    """Prefill a right-padded batch of 2 (true lengths 13 and 7 in 24),
    then greedy-decode ``steps`` tokens on both sides, each fed its own
    argmax, at the kernel path's KV bound."""
    jm, jp, tm, tp = _models(variant, dtype)
    B, S, max_len = 2, 24, 48
    rng = np.random.default_rng(9)
    toks = rng.integers(1, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    true_len = np.array([13, 7], np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 strip(jm.init_cache(B, max_len)),
                                 true_len=jnp.asarray(true_len))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(B, max_len),
                        true_len=torch.from_numpy(true_len),
                        use_kernels=use_kernels)
    jstep = jax.jit(jm.decode_step, static_argnames=("use_kernels",
                                                     "kv_bound"))
    live = np.array([True, True])
    parted = [False] * B
    for step in range(steps + 1):
        jl_np, tl_np = np.asarray(jl, np.float32), tl.float().numpy()
        for b in range(B):
            if parted[b]:
                continue
            assert _rel(tl_np[b], jl_np[b]) <= tol, (step, b)
            if jl_np[b].argmax() != tl_np[b].argmax():
                top2 = np.sort(jl_np[b])[-2:]
                margin = (top2[1] - top2[0]) / np.abs(jl_np[b]).max()
                assert not exact_streams and margin < tol, (step, b, margin)
                parted[b] = True
        if step == steps or all(parted):
            break
        bound = min(-(-(int(true_len.max()) + step + 1) // 32) * 32, max_len)
        jn = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tn = tl.argmax(-1).to(torch.int32)[:, None]
        jl, jc = jstep(jp, jc, jn, use_kernels=use_kernels, kv_bound=bound,
                       live_mask=jnp.asarray(live))
        tl, tc = tm.decode_step(tp, tc, tn, use_kernels=use_kernels,
                                kv_bound=bound, live_mask=torch.tensor(live))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_fp32_match_reference(variant, use_kernels):
    _run(variant, "float32", use_kernels=use_kernels, steps=6,
         tol=FP32_LOGIT_TOL, exact_streams=True)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_bf16_within_tolerance(variant):
    _run(variant, "bfloat16", use_kernels=True, steps=6, tol=BF16_LOGIT_TOL,
         exact_streams=False)


def test_bridge_carries_mqa_and_gelu_ffn():
    _, jp, tm, tp = _models("g48")
    cfg = tm.cfg
    attn = tp["decoder"]["layers"][0]["attn"]
    assert attn["wq"].shape == (cfg.d_model, 48, 16)
    assert attn["wk"].shape == attn["wv"].shape == (cfg.d_model, 1, 16)
    ffn = tp["decoder"]["layers"][0]["ffn"]
    assert cfg.act == "gelu" and not cfg.glu and set(ffn) == set(
        jp["decoder"]["scanned"]["ffn"])


# ---------------------------------------------------------------------------
# DecodeEngine
# ---------------------------------------------------------------------------

def _per_token(engine_cls, cfg):
    """An engine's admission count of KV elements per token, from its
    config alone (no weights built)."""
    return engine_cls._per_token_cache_elems(
        types.SimpleNamespace(model=types.SimpleNamespace(cfg=cfg)))


def test_per_token_cache_elems_match_reference():
    """MQA keeps one KV head: 2 x 1 x 128 x 88 = 22528 elements per token
    for granite-34b, as the JAX engine counts."""
    for tcfg, jcfg in ((get_config("granite-34b"),
                        jax_get_config("granite-34b")),
                       (get_reduced("granite-34b"),
                        jax_get_reduced("granite-34b"))):
        assert _per_token(DecodeEngine, tcfg) == _per_token(JaxEngine, jcfg)
    assert _per_token(DecodeEngine, get_config("granite-34b")) == 22528


def _drive(eng, new, seed, preempt_at=()):
    rng = np.random.default_rng(seed)
    rids = [eng.submit(rng.integers(1, 256, size=int(rng.integers(3, 14))),
                       max_new_tokens=new) for _ in range(6)]
    steps = 0
    while eng.has_work:
        if steps in preempt_at:
            eng.preempt_one()
        eng.step()
        steps += 1
        assert steps < 500
    assert eng.arena.used == 0
    res = eng.results()
    return [res[r] for r in rids]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_streams_match_reference_through_preemption(variant,
                                                           pipeline):
    """Paged admission at half the dense worst case preempts and resumes,
    and an explicit preempt_one mid-run too; every stream equals the JAX
    engine's."""
    jm, jp, tm, tp = _models(variant)
    kw = dict(max_slots=3, max_len=32, eos_id=-1, paged_kv=True,
              kv_page_rows=4, kv_arena_frac=0.5, pipeline_decode=pipeline,
              use_kernels=True)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = DecodeEngine(tm, tp, ServeConfig(**kw))
    want = _drive(jeng, 10, seed=1, preempt_at=(4,))
    got = _drive(teng, 10, seed=1, preempt_at=(4,))
    assert teng.preempt_count >= 2
    assert teng.preempt_count == jeng.preempt_count
    assert got == want and all(len(t) == 10 for t in got)


# ---------------------------------------------------------------------------
# the ragged decode kernel past G = 8: plain version and split spec
# ---------------------------------------------------------------------------

def _qkv(rng, B, T, Hq, Hkv, D):
    return (rng.normal(size=(B, 1, Hq, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("G,Hkv", [(5, 2), (9, 2), (48, 1)])
@pytest.mark.parametrize("window,cap,glob", [
    (0, 0.0, None), (8, 20.0, False), (8, 0.0, True)])
def test_ragged_plain_and_split_match_pallas_past_eight(G, Hkv, window, cap,
                                                        glob):
    """The plain version and the split spec (chunks of 4: most are empty;
    of 32: one window start inside a chunk) against the Pallas kernel in
    interpret mode, with a dead row; dead rows are exact zeros."""
    B, T, D = 5, 64, 16
    q, k, v = _qkv(np.random.default_rng(G), B, T, G * Hkv, Hkv, D)
    lens = np.array([1, 17, 64, 40, 33], np.int32)
    live = np.array([True, True, True, False, True])
    kw = dict(window=window, logit_cap=cap, is_global=glob)
    want = np.asarray(jax_rd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens), live=jnp.asarray(live),
                             impl="interpret", **kw))
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    tl, tlive = torch.tensor(lens), torch.tensor(live)
    got = ragged_decode_attention_ref(tq, tk, tv, tl, live=tlive, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RAGGED_TOL,
                               atol=RAGGED_TOL)
    for chunk in (4, 32):
        split = ragged_decode_split_ref(tq, tk, tv, tl, chunk=chunk,
                                        live=tlive, **kw)
        np.testing.assert_allclose(split.numpy(), want, rtol=RAGGED_TOL,
                                   atol=RAGGED_TOL)
        assert (split[3] == 0).all()
    assert (got[3] == 0).all()


def test_head_groups_tickets_and_split_plan_count_the_groups():
    """G = 48 is 6 groups of 8 (granite), 9 is 5 + 4, up to 8 one group.
    The split plan counts the groups: at granite's serving shape (8 slots,
    1 KV head, kv_bound 2048, 132 SMs) the grid is about the blocks the
    plan aims at, not six times them, and the tickets are one per (slot,
    KV head, group)."""
    assert [head_groups(g) for g in (1, 3, 8, 9, 16, 25, 48)] == [
        (1, 1), (1, 3), (1, 8), (2, 5), (2, 8), (4, 7), (6, 8)]
    assert rd.ticket_count(8, 48, 1) == 48
    assert rd.ticket_count(8, 24, 8) == 64
    assert rd.ticket_count(8, 25, 5) == 40
    groups = head_groups(48)[0]
    chunk, n = rd.split_plan(8, 48, 1, 2048, 132)
    one_chunk, one_n = rd.split_plan(8, 8, 1, 2048, 132)     # one group
    blocks = 8 * 1 * groups * n
    assert chunk % 32 == 0 and (n - 1) * chunk < 2048 <= n * chunk
    assert 8 * 132 <= blocks <= 2 * 8 * 132
    assert 8 * one_n <= 2 * 8 * 132 and n < one_n
    # G of 8 or less is one group: the plan depends on Hkv alone
    assert rd.split_plan(8, 24, 8, 1056, 132) == \
        rd.split_plan(8, 8, 8, 1056, 132) == rd.split_plan(8, 64, 8, 1056, 132)
    # G = 9 is two groups: fewer splits than G = 8, one group
    assert rd.split_plan(8, 18, 2, 2048, 132)[1] < \
        rd.split_plan(8, 16, 2, 2048, 132)[1]


def test_wrapper_takes_plain_on_cpu_at_g48():
    q, k, v = (torch.tensor(a) for a in _qkv(np.random.default_rng(0), 3,
                                             32, 48, 1, 16))
    lens = torch.tensor([5, 32, 9], dtype=torch.int32)
    live = torch.tensor([True, False, True])
    before = rd.launches
    got = rd.ragged_decode_attention(q, k, v, lens, live=live, window=4)
    want = ragged_decode_attention_ref(q, k, v, lens, live=live, window=4)
    assert torch.equal(got, want) and rd.launches == before
