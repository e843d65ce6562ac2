"""Port parity for the whole model: ``repro_torch`` ``Model.prefill`` plus
greedy ``decode_step`` s against the JAX ``Model`` on minitron-reduced,
qwen2.5-reduced and falcon-mamba-reduced, with the JAX init's weights
carried over by ``params_from_jax``.

fp32 leg (``dtype="float32"``): greedy streams equal, logits within 1e-4
of the largest |logit| (summation order only).  bf16 leg: logits within
BF16_LOGIT_TOL of the largest |logit| while the streams agree (bf16
rounds at other points in the two frameworks: a few 2**-8 ulps over two
layers), and the streams may part only where the reference's top-2 margin
is below that tolerance (a near-tie).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

FP32_LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 3e-2
ARCHS = ["minitron-4b", "qwen2.5-32b", "falcon-mamba-7b"]


def _pair(arch, dtype):
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = strip(jm.init(jax.random.key(0)))
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run(jm, jp, tm, tp, *, use_kernels, steps, tol, exact_streams):
    """Prefill a right-padded batch (true lengths 11 and 6 in 16), then
    greedy-decode ``steps`` tokens on both sides, each fed its own argmax.
    An SSM arch prefills an exact-length batch of 11 tokens instead: padding
    would enter its recurrent state."""
    B, S, max_len = 2, 16, 40
    ssm = jm.cfg.ssm is not None
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    true_len = np.array([11, 6], np.int32)
    if ssm:
        toks, true_len = toks[:, :11], np.array([11, 11], np.int32)
    prefill = jax.jit(jm.prefill)
    jstep = jax.jit(jm.decode_step, static_argnames=("use_kernels",
                                                     "kv_bound"))
    jl, jc = prefill(jp, {"tokens": jnp.asarray(toks)},
                     strip(jm.init_cache(B, max_len)),
                     true_len=None if ssm else jnp.asarray(true_len))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(B, max_len),
                        true_len=None if ssm else torch.from_numpy(true_len),
                        use_kernels=use_kernels)
    live = np.array([True, True])
    parted = [False] * B
    for step in range(steps + 1):
        jl_np, tl_np = np.asarray(jl, np.float32), tl.float().numpy()
        for b in range(B):
            if parted[b]:
                continue
            assert _rel(tl_np[b], jl_np[b]) <= tol, (step, b)
            jt, tt = jl_np[b].argmax(), tl_np[b].argmax()
            if jt != tt:
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_fp32_match_reference(arch, use_kernels):
    jm, jp, tm, tp = _pair(arch, "float32")
    _run(jm, jp, tm, tp, use_kernels=use_kernels, steps=6,
         tol=FP32_LOGIT_TOL, exact_streams=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bf16_within_tolerance(arch):
    jm, jp, tm, tp = _pair(arch, "bfloat16")
    _run(jm, jp, tm, tp, use_kernels=True, steps=6, tol=BF16_LOGIT_TOL,
         exact_streams=False)


def test_bridge_layouts_and_dtypes():
    jm, jp, tm, tp = _pair("qwen2.5-32b", "bfloat16")
    cfg = tm.cfg
    layers = tp["decoder"]["layers"]
    assert len(layers) == cfg.num_layers
    attn = layers[1]["attn"]
    assert attn["wq"].shape == (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)
    assert attn["wo"].shape == (cfg.num_heads, cfg.resolved_head_dim, cfg.d_model)
    assert attn["wq"].dtype == torch.bfloat16 and "bq" in attn
    assert layers[0]["ln1"]["scale"].dtype == torch.float32
    assert tp["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    assert tp["lm_head"].shape == (cfg.d_model, cfg.padded_vocab)
    want = np.asarray(jp["decoder"]["scanned"]["attn"]["wk"][1])
    np.testing.assert_array_equal(
        attn["wk"].float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))


def test_cache_slot_axes_match_reference():
    jm, _, tm, _ = _pair("minitron-4b", "float32")
    jaxes = jm.cache_slot_axes(strip(jm.init_cache(3, 8)))
    taxes = tm.cache_slot_axes(tm.init_cache(3, 8))
    assert jax.tree.leaves(jaxes) == jax.tree.leaves(taxes)
    assert taxes == {"prologue": [], "scanned": {"attn": {"k": 1, "v": 1}},
                     "pos": 0}


def test_init_is_seeded_and_masks_vocab_padding():
    cfg = dataclasses.replace(get_reduced("minitron-4b"), vocab_size=200)
    m = Model(cfg, "cpu")
    p1 = m.init(torch.Generator().manual_seed(0))
    p2 = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(p1["embed"], p2["embed"])
    assert p1["embed"].shape == (256, cfg.d_model)
    logits, cache = m.prefill(p1, {"tokens": torch.ones((1, 5), dtype=torch.int32)},
                              m.init_cache(1, 8))
    assert logits.shape == (1, 256)
    assert (logits[:, 200:] == -1e30).all() and int(logits.argmax()) < 200
    assert cache["pos"].tolist() == [5]
