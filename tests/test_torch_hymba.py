"""Port parity for the hybrid decoder (hymba: GQA attention beside a Mamba
block in every layer, outputs fused as 0.5 (rmsnorm(a) + rmsnorm(s)),
sliding-window layers but the global ones): ``repro_torch``'s hybrid
layer, ``Model`` and ``DecodeEngine`` against the JAX package's on
hymba-reduced (window 8, layer 0 global), with the JAX init's weights
carried over by ``params_from_jax``.

Prompts are longer than the window, so the sliding layer masks, and at
least 3 tokens long: the reference keeps a short conv window for shorter
prompts (``ROADMAP.md``, the reference's faults).  A hybrid arch prefills
at exact lengths: padding would enter its recurrent state.

fp32: a layer's output and cache within 1e-5, logits within 1e-4 of the
largest |logit| and greedy streams equal; engine streams equal the JAX
engine's request by request, through paged preemption, live slot resizes
and evacuation and adoption (a slot's KV rows and Mamba state move
together).  bf16: logits within 3e-2, streams parting only at near-ties,
as ``test_torch_model.py`` holds them.
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
from repro.core.dse import DesignPoint as JaxDesignPoint  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads.decode import DecodeEngine as JaxEngine  # noqa: E402
from repro.workloads.decode import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.dse import DesignPoint  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads.decode import DecodeEngine, ServeConfig  # noqa: E402

ARCH = "hymba-1.5b"
LAYER_TOL = 1e-5
FP32_LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 3e-2
_MODELS = {}


def _models(dtype="float32"):
    if dtype not in _MODELS:
        jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype=dtype)
        tcfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
        jm = jax_build_model(jcfg)
        jp = strip(jm.init(jax.random.key(4)))
        tm = Model(tcfg, "cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[dtype] = (jm, jp, tm, tp)
    return _MODELS[dtype]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the hybrid layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", [0, 1])          # 0 global, 1 sliding
@pytest.mark.parametrize("use_kernels", [True, False])
def test_hybrid_layer_prefill_and_step_match_reference(layer, use_kernels):
    """One hybrid layer: prefill of a 13-token prompt (past the window of
    8) into a fresh cache, then 4 steps, one row dead on the last; the
    output and every cache leaf (K, V, conv window, state) against the
    reference's layer."""
    jm, jp, tm, tp = _models()
    cfg = tm.cfg
    glob = layer in cfg.global_attn_layers
    jlp = jax.tree.map(lambda a: a[layer], jp["decoder"]["scanned"])
    tlp = tp["decoder"]["layers"][layer]
    B, S, max_len = 2, 13, 24
    rng = np.random.default_rng(layer)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jc = strip(JT._layer_cache_init(jm.cfg, B, max_len, jnp.float32))
    tc = TT._layer_cache_init(cfg, B, max_len, torch.float32, "cpu", 0)
    jy, jc = JT._layer_prefill(jlp, jm.cfg, jnp.asarray(x), jnp.asarray(pos),
                               jc, is_global=jnp.asarray(glob))
    ty, tc = TT._layer_prefill(tlp, cfg, torch.tensor(x),
                               torch.tensor(pos.copy()), tc, is_global=glob,
                               use_kernels=use_kernels)
    _close(ty, jy)
    jpos = jnp.full((B,), S, jnp.int32)
    tpos = torch.full((B,), S, dtype=torch.int32)
    for step in range(4):
        x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        live = np.array([True, step < 3])
        jy, jc = JT._layer_step(jlp, jm.cfg, jnp.asarray(x1), jc, jpos,
                                is_global=jnp.asarray(glob),
                                use_kernels=use_kernels, kv_bound=24,
                                live=jnp.asarray(live))
        ty, tc = TT._layer_step(tlp, cfg, torch.tensor(x1), tc, tpos,
                                is_global=glob, use_kernels=use_kernels,
                                kv_bound=24, live=torch.tensor(live))
        rows = slice(None) if live.all() or not use_kernels else slice(0, 1)
        _close(ty[rows], np.asarray(jy)[rows])
        jpos, tpos = jpos + 1, tpos + 1
    for key in ("attn", "ssm"):
        for name in jc[key]:
            _close(tc[key][name], jc[key][name])


def test_bridge_carries_both_blocks_and_output_norms():
    _, jp, tm, tp = _models("bfloat16")
    lp = tp["decoder"]["layers"][1]
    assert {"attn", "ssm", "attn_out_norm", "ssm_out_norm", "ffn"} <= set(lp)
    assert lp["attn_out_norm"]["scale"].dtype == torch.float32
    assert lp["ssm_out_norm"]["scale"].dtype == torch.float32
    assert lp["ssm"]["A_log"].dtype == torch.float32
    assert lp["ssm"]["in_proj"].dtype == lp["attn"]["wq"].dtype == \
        torch.bfloat16
    want = np.asarray(jp["decoder"]["scanned"]["ssm_out_norm"]["scale"][1])
    np.testing.assert_array_equal(lp["ssm_out_norm"]["scale"].numpy(), want)


def test_cache_slot_axes_match_reference():
    jm, _, tm, _ = _models()
    jaxes = jm.cache_slot_axes(strip(jm.init_cache(3, 8)))
    taxes = tm.cache_slot_axes(tm.init_cache(3, 8))
    assert jax.tree.leaves(jaxes) == jax.tree.leaves(taxes)
    assert taxes["scanned"] == {"attn": {"k": 1, "v": 1},
                                "ssm": {"conv": 1, "h": 1}}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _run(dtype, *, use_kernels, steps, tol, exact_streams):
    """Prefill a batch of 2 exact-length 13-token prompts, then
    greedy-decode ``steps`` tokens on both sides, each fed its own argmax,
    at the kernel path's KV bound (the decode rows cross the window)."""
    jm, jp, tm, tp = _models(dtype)
    B, S, max_len = 2, 13, 40
    rng = np.random.default_rng(6)
    toks = rng.integers(1, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 strip(jm.init_cache(B, max_len)))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(B, max_len), use_kernels=use_kernels)
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
        bound = min(-(-(S + step + 1) // 32) * 32, max_len)
        jn = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tn = tl.argmax(-1).to(torch.int32)[:, None]
        jl, jc = jstep(jp, jc, jn, use_kernels=use_kernels, kv_bound=bound,
                       live_mask=jnp.asarray(live))
        tl, tc = tm.decode_step(tp, tc, tn, use_kernels=use_kernels,
                                kv_bound=bound, live_mask=torch.tensor(live))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_fp32_match_reference(use_kernels):
    _run("float32", use_kernels=use_kernels, steps=8, tol=FP32_LOGIT_TOL,
         exact_streams=True)


def test_prefill_and_decode_bf16_within_tolerance():
    _run("bfloat16", use_kernels=True, steps=8, tol=BF16_LOGIT_TOL,
         exact_streams=False)


def test_encode_matches_reference():
    """The no-cache forward (embedding workloads): the hybrid layer's Mamba
    block folds the sequence from a zero state, the reference's
    ``mamba_fwd``."""
    jm, jp, tm, tp = _models()
    toks = np.random.default_rng(8).integers(1, 256, size=(2, 19)).astype(
        np.int32)
    want = jm.encode(jp, {"tokens": jnp.asarray(toks)})
    got = tm.encode(tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= FP32_LOGIT_TOL


# ---------------------------------------------------------------------------
# DecodeEngine
# ---------------------------------------------------------------------------

def _per_token(engine_cls, cfg):
    return engine_cls._per_token_cache_elems(
        types.SimpleNamespace(model=types.SimpleNamespace(cfg=cfg)))


def test_per_token_cache_elems_and_prefill_lengths_match_reference():
    """A hybrid arch is admitted on its KV rows (2 x 5 x 64 x 32 = 20480
    elements per token at full size), as the JAX engine counts, and seeds
    no bucketed prefill length: it prefills at exact lengths."""
    for tcfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                       (get_reduced(ARCH), jax_get_reduced(ARCH))):
        assert _per_token(DecodeEngine, tcfg) == _per_token(JaxEngine, jcfg)
    assert _per_token(DecodeEngine, get_config(ARCH)) == 20480
    _, _, tm, tp = _models()
    eng = DecodeEngine(tm, tp, ServeConfig(max_slots=2, max_len=32))
    assert eng._prefill_lens == set() and eng._decode_bounds() == (32,)


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
@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_streams_match_reference_through_preemption(pipeline,
                                                           use_kernels):
    """Paged admission at half the dense worst case preempts and resumes,
    and an explicit preempt_one mid-run too: a parked slot takes its KV
    rows and its Mamba state with it.  Every stream equals the JAX
    engine's."""
    jm, jp, tm, tp = _models()
    kw = dict(max_slots=3, max_len=32, eos_id=-1, paged_kv=True,
              kv_page_rows=4, kv_arena_frac=0.5, pipeline_decode=pipeline,
              use_kernels=use_kernels)
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = DecodeEngine(tm, tp, ServeConfig(**kw))
    prompts = _prompts(6, seed=0, hi=14)
    want = _drive(jeng, prompts, 12, preempt_at=(4,))
    got = _drive(teng, prompts, 12, preempt_at=(4,))
    assert teng.preempt_count >= 2
    assert teng.preempt_count == jeng.preempt_count
    assert got == want and all(len(t) == 12 for t in got)


def test_engine_slot_resizes_match_reference():
    """3 slots grow to 5, shrink to 2 (clamped at the live count) and grow
    to 4 mid-stream: each slot's KV and state move together."""
    jm, jp, tm, tp = _models()
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
    """A preempted, an evacuated and an adopted hybrid slot resume exactly:
    the streams equal the JAX engines' and an uninterrupted run's."""
    jm, jp, tm, tp = _models()
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

def test_launcher_serves_hymba_and_granite_alone_and_as_fabric_tenants(
        capsys):
    """Both new families take ``DecodeEngine`` (the decode class: hymba
    holds KV beside its state) alone and as two tenants of one fabric."""
    import json

    from repro_torch.launch import serve

    for arch, name in (("hymba-1.5b", "hymba-reduced"),
                       ("granite-34b", "granite-reduced")):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-new-tokens", "5"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["arch"] == name and out["workload_class"] == "decode"
        assert out["tokens_emitted"] == 3 * (5 - 1)
    assert serve.main(["--fabric", "--arch", "hymba-1.5b", "--arch",
                       "granite-34b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new-tokens", "6",
                       "--log-every", "0"]) == 0
    out = json.loads(capsys.readouterr().out)
    tenants = ["tenant0-hymba-1.5b", "tenant1-granite-34b"]
    assert out["tenants"] == tenants
    assert sum(out["tokens_emitted"].values()) == 2 * 3 * (6 - 1)
    assert out["serving_captures"] == dict.fromkeys(tenants, 0)
