"""Port parity for the MLA and MoE models end to end: ``repro_torch``'s
``Model`` and ``DecodeEngine`` against the JAX package's on
deepseek-v2-lite-reduced (MLA, a dense prologue layer, routed plus shared
experts) and arctic-reduced (GQA, MoE beside a dense residual FFN), with
the JAX init's weights carried over by ``params_from_jax``.

fp32: greedy streams equal and logits within 1e-5 of the largest |logit|,
over a prompt whose length is off the prefill bucket; engine streams equal
the JAX engine's request by request, through paged preemption, live slot
resizes, and evacuation and adoption.  bf16: logits within 3e-2 (as
``test_torch_model.py`` holds them) of the reference run op by op, streams
parting only at near-ties.  Compiled, the reference's bf16 keeps fp32
intermediates inside its fused elementwise ops, so its router picks
another expert where two are within about 1e-4 of each other: on
arctic-reduced its compiled logits lie 9% from its own op-by-op logits.
The port rounds where the op-by-op reference rounds; its routing parts
from the compiled reference's only at such near-ties (held below).
Admission counts MLA's latent per token: 576 x 27 = 15552 elements for
deepseek-v2-lite, as the JAX engine counts.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.dse import DesignPoint as JaxDesignPoint  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads.decode import DecodeEngine as JaxEngine  # noqa: E402
from repro.workloads.decode import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.dse import DesignPoint  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.workloads.decode import DecodeEngine, ServeConfig  # noqa: E402

ARCHS = ("deepseek-v2-lite-16b", "arctic-480b")
FP32_LOGIT_TOL = 1e-5
BF16_LOGIT_TOL = 3e-2
_MODELS = {}


def _models(arch, dtype="float32", seed=0):
    key = (arch, dtype, seed)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=dtype)
        tcfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
        jm = jax_build_model(jcfg)
        jp = strip(jm.init(jax.random.key(seed)))
        tm = Model(tcfg, "cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run(arch, dtype, *, use_kernels, steps, tol, exact_streams,
         op_by_op=False):
    """Prefill a right-padded batch of 2 (true lengths 13 and 7 in 24: off
    any bucket), then greedy-decode ``steps`` tokens on both sides, each
    fed its own argmax, with the kernel path's KV bound.  ``op_by_op``
    runs the reference without compiling it."""
    if op_by_op:
        with jax.disable_jit():
            return _run(arch, dtype, use_kernels=use_kernels, steps=steps,
                        tol=tol, exact_streams=exact_streams)
    jm, jp, tm, tp = _models(arch, dtype)
    B, S, max_len = 2, 24, 48
    rng = np.random.default_rng(5)
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
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_fp32_match_reference(arch, use_kernels):
    jc, tc = _run(arch, "float32", use_kernels=use_kernels, steps=6,
                  tol=FP32_LOGIT_TOL, exact_streams=True)
    # the caches hold the same rows: the prologue's and the scanned
    # layers' (MLA latents or GQA K/V)
    jl, tl = jax.tree.leaves(jc), jax.tree.leaves(tc)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        if b.dtype.is_floating_point:
            assert _rel(b, a) <= FP32_LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bf16_within_tolerance(arch):
    _run(arch, "bfloat16", use_kernels=True, steps=6, tol=BF16_LOGIT_TOL,
         exact_streams=False, op_by_op=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_routing_parts_from_compiled_reference_at_near_ties(
        arch, monkeypatch):
    """The compiled reference's bf16 prefill and the port's pick the same
    top-k experts for every token (padding included), but where the
    reference's k-th and (k+1)-th router probabilities lie within 1e-3."""
    from repro.models import moe as JM
    from repro_torch.models import moe as TM

    jm, jp, tm, tp = _models(arch, "bfloat16")
    seen = {"jax": [], "port": []}
    jax_routing, port_routing = JM._routing, TM._routing

    def jrec(p, mo, xg):
        g, i, pr = jax_routing(p, mo, xg)
        jax.debug.callback(lambda i_, pr_: seen["jax"].append(
            (np.asarray(i_), np.asarray(pr_))), i, pr)
        return g, i, pr

    def trec(p, mo, xg):
        g, i, pr = port_routing(p, mo, xg)
        seen["port"].append(i.numpy())
        return g, i, pr

    monkeypatch.setattr(JM, "_routing", jrec)
    monkeypatch.setattr(TM, "_routing", trec)
    toks = np.random.default_rng(5).integers(1, 256, (2, 24)).astype(
        np.int32)
    true_len = np.array([13, 7], np.int32)
    jax.jit(lambda *a, **k: jm.prefill(*a, **k))(
        jp, {"tokens": jnp.asarray(toks)}, strip(jm.init_cache(2, 48)),
        true_len=jnp.asarray(true_len))
    jax.effects_barrier()
    tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tm.init_cache(2, 48),
               true_len=torch.from_numpy(true_len))
    k = tm.cfg.moe.top_k
    assert len(seen["jax"]) == len(seen["port"]) == \
        len(tp["decoder"]["layers"])
    for (ji, jpr), ti in zip(seen["jax"], seen["port"]):
        parted = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
        ranked = np.sort(jpr, -1)[..., ::-1]
        gap = ranked[..., k - 1] - ranked[..., k]
        assert (gap[parted] < 1e-3).all(), gap[parted]


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_dispatch_keyword_reaches_every_layer(dispatch):
    """``moe_dispatch`` through ``Model.prefill`` and ``decode_step``
    matches the reference model's on the same keyword."""
    jm, jp, tm, tp = _models("deepseek-v2-lite-16b")
    toks = np.random.default_rng(2).integers(1, 256, (1, 10)).astype(
        np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        strip(jm.init_cache(1, 16)), moe_dispatch=dispatch)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(1, 16), moe_dispatch=dispatch)
    assert _rel(tl, jl) <= FP32_LOGIT_TOL
    nxt = np.array([[7]], np.int32)
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(nxt), moe_dispatch=dispatch)
    tl, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                           moe_dispatch=dispatch)
    assert _rel(tl, jl) <= FP32_LOGIT_TOL


def test_bridge_carries_prologue_and_stacked_experts():
    jm, jp, tm, tp = _models("deepseek-v2-lite-16b", "bfloat16")
    cfg = tm.cfg
    dec = tp["decoder"]
    assert len(dec["prologue"]) == cfg.moe.first_k_dense == 1
    assert len(dec["layers"]) == cfg.num_layers - 1
    pro = dec["prologue"][0]
    assert "moe" not in pro
    assert pro["ffn"]["w_up"].shape == (cfg.d_model,
                                        cfg.moe.first_dense_d_ff)
    moe = dec["layers"][0]["moe"]
    assert moe["experts"]["w_up"].shape == (
        cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff)
    assert moe["router"].dtype == torch.bfloat16
    attn = dec["layers"][0]["attn"]
    assert attn["kv_norm"].dtype == torch.float32
    assert attn["w_dkv"].dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(
        jp["decoder"]["scanned"]["moe"]["experts"]["w_down"][0, 3]).astype(
            jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(
        moe["experts"]["w_down"][3].float().numpy(), want)
    arctic = _models("arctic-480b", "bfloat16")[3]["decoder"]
    assert arctic["prologue"] == [] and "dense" in arctic["layers"][1]["moe"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slot_axes_match_reference(arch):
    jm, _, tm, _ = _models(arch)
    jaxes = jm.cache_slot_axes(strip(jm.init_cache(3, 8)))
    taxes = tm.cache_slot_axes(tm.init_cache(3, 8))
    assert jax.tree.leaves(jaxes) == jax.tree.leaves(taxes)
    if arch == "deepseek-v2-lite-16b":
        assert taxes == {"prologue": [{"attn": {"ckv": 0, "krope": 0}}],
                         "scanned": {"attn": {"ckv": 1, "krope": 1}},
                         "pos": 0}


def test_check_supported_takes_mla_and_moe():
    for arch in ARCHS:
        check_supported(get_config(arch))
        check_supported(get_reduced(arch))
    check_supported(dataclasses.replace(get_reduced(ARCHS[0]),
                                        hybrid_parallel=True))
    with pytest.raises(NotImplementedError, match="slice"):
        check_supported(dataclasses.replace(get_reduced(ARCHS[0]),
                                            encoder_layers=2,
                                            ssm=get_reduced("hymba-1.5b").ssm))


# ---------------------------------------------------------------------------
# DecodeEngine
# ---------------------------------------------------------------------------

def _per_token(engine_cls, cfg):
    """An engine's admission count of KV elements per token, from its
    config alone (no weights built)."""
    return engine_cls._per_token_cache_elems(
        types.SimpleNamespace(model=types.SimpleNamespace(cfg=cfg)))


@pytest.mark.parametrize("arch", ARCHS + ("minitron-4b",))
def test_per_token_cache_elems_match_reference(arch):
    """MLA caches its latent and rope key, kv_lora_rank + qk_rope_head_dim
    per token and layer: 576 x 27 = 15552 for deepseek-v2-lite, not
    2 x 16 x 128 x 27."""
    for tcfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                       (get_reduced(arch), jax_get_reduced(arch))):
        assert _per_token(DecodeEngine, tcfg) == _per_token(JaxEngine, jcfg)
    if arch == "deepseek-v2-lite-16b":
        assert _per_token(DecodeEngine, get_config(arch)) == 15552
        _, _, tm, tp = _models(arch)
        eng = DecodeEngine(tm, tp, ServeConfig(max_slots=2, max_len=32))
        assert eng._per_token_cache_elems() == (32 + 8) * 2


def _prompts(n, seed, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=int(rng.integers(lo, hi)))
            for _ in range(n)]


def _drive(eng, prompts, new, schedule=(), point_cls=None, preempt_at=()):
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    steps = 0
    while eng.has_work:
        if steps in schedule:
            eng.apply(None, point_cls(cus=0, slots=schedule[steps]))
        if steps in preempt_at:
            eng.preempt_one()
        eng.step()
        steps += 1
        assert steps < 500
    assert eng.arena.used == 0
    res = eng.results()
    return [res[r] for r in rids]


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_streams_match_reference_through_preemption(pipeline):
    """Paged admission at half the dense worst case preempts and resumes;
    an explicit preempt_one mid-run too; every stream equals the JAX
    engine's."""
    jm, jp, tm, tp = _models("deepseek-v2-lite-16b")
    kw = dict(max_slots=3, max_len=32, eos_id=-1, paged_kv=True,
              kv_page_rows=4, kv_arena_frac=0.5, pipeline_decode=pipeline)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = DecodeEngine(tm, tp, ServeConfig(**kw))
    prompts = _prompts(6, seed=0, hi=12)
    want = _drive(jeng, prompts, 12, preempt_at=(4,))
    got = _drive(teng, prompts, 12, preempt_at=(4,))
    assert teng.preempt_count >= 2
    assert teng.preempt_count == jeng.preempt_count
    assert got == want and all(len(t) == 12 for t in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_slot_resizes_match_reference(arch):
    """3 slots grow to 5, shrink to 2 (clamped at the live count) and grow
    to 4 mid-stream: the prologue's and the scanned layers' caches move
    with their slots, and the streams equal the reference's."""
    jm, jp, tm, tp = _models(arch)
    kw = dict(max_slots=3, max_len=48, eos_id=-1, paged_kv=True,
              kv_page_rows=4)
    schedule = {2: 5, 5: 2, 9: 4}
    prompts = _prompts(7, seed=11)
    want = _drive(JaxEngine(jm, jp, JaxServeConfig(**kw)), prompts, 10,
                  schedule, JaxDesignPoint)
    teng = DecodeEngine(tm, tp, ServeConfig(**kw))
    got = _drive(teng, prompts, 10, schedule, DesignPoint)
    assert got == want and teng.cfg.max_slots == 4


def _evacuate(make, prompts, new):
    """Engine a (3 slots) serves two steps and parks one request, then
    evacuates; engine b (2 slots) adopts the live, parked and queued
    requests (growing for the third live one) and finishes them."""
    a, b = make(3), make(2)
    rids = [a.submit(p, max_new_tokens=new) for p in prompts]
    a.step()
    a.step()
    assert a.preempt_one() is not None
    live, queued = a.evacuate()
    assert a.arena.used == 0 and not a.has_work
    order = {req.rid: req for req, _ in live}
    order.update({req.rid: req for req in queued})
    for req, block in live:
        b.adopt_request(req, block)
    for req in queued:
        b.adopt_queued(req)
    while b.has_work:
        b.step()
    b.results()
    return [list(order[r].out_tokens) for r in rids]


def test_engine_evacuate_and_adopt_match_reference_and_uninterrupted():
    jm, jp, tm, tp = _models("deepseek-v2-lite-16b")
    kw = dict(max_len=48, eos_id=-1, paged_kv=True)
    prompts = _prompts(5, seed=7)
    got = _evacuate(lambda n: DecodeEngine(tm, tp, ServeConfig(
        max_slots=n, **kw)), prompts, 9)
    want = _evacuate(lambda n: JaxEngine(jm, jp, JaxServeConfig(
        max_slots=n, **kw)), prompts, 9)
    plain = _drive(DecodeEngine(tm, tp, ServeConfig(max_slots=5, **kw)),
                   prompts, 9)
    assert got == want == plain
    assert all(len(t) == 9 for t in got)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_deepseek_alone_and_as_a_fabric_tenant(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced",
                       "--device", "cpu", "--requests", "3",
                       "--max-new-tokens", "5"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "deepseek-v2-lite-reduced"
    assert out["workload_class"] == "decode"
    # step() reports decoded tokens; each prefill's first token is not one
    assert out["tokens_emitted"] == 3 * (5 - 1)
    assert serve.main(["--fabric", "--arch", "deepseek-v2-lite-16b",
                       "--arch", "minitron-4b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--max-new-tokens", "6",
                       "--log-every", "0"]) == 0
    out = json.loads(capsys.readouterr().out)
    tenants = ["tenant0-deepseek-v2-lite-16b", "tenant1-minitron-4b"]
    assert out["tenants"] == tenants
    assert sum(out["tokens_emitted"].values()) == 2 * 3 * (6 - 1)
    assert out["serving_captures"] == dict.fromkeys(tenants, 0)
