"""Port parity for the rest of the dense family: the four configs the port
copies (granite-34b, hymba-1.5b, qwen1.5-110b, chameleon-34b) against
the reference's field by field, and ``Model`` on qwen1.5-reduced (QKV
bias) and chameleon-reduced (QK-norm) against the JAX ``Model``, with the
JAX init's weights carried over by ``params_from_jax``.

The JAX init leaves the biases at zero and the QK-norm scales at one,
where a path that skipped them would agree all the same; so these tests
draw them from a seeded numpy normal on both sides first.

fp32: greedy streams equal and logits within 1e-4 of the largest |logit|
over a right-padded batch; bf16: logits within 3e-2, streams parting only
at near-ties, as ``test_torch_model.py`` holds them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402

NEW_ARCHS = ("granite-34b", "hymba-1.5b", "qwen1.5-110b", "chameleon-34b")
FP32_LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 3e-2
# the attention parameters the JAX init leaves at zero or one
_DRAWN = ("bq", "bk", "bv", "q_norm", "k_norm")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_reference(arch):
    for get_t, get_j in ((TC.get_config, jax_get_config),
                         (TC.get_reduced, jax_get_reduced)):
        ct, cj = get_t(arch), get_j(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.param_count() == cj.param_count()
        assert ct.padded_vocab == cj.padded_vocab
        assert ct.resolved_head_dim == cj.resolved_head_dim
        assert ct.attention_free == cj.attention_free
        check_supported(ct)
    assert arch in TC.ARCH_IDS
    assert TC.get_reduced(arch).activation_dtype == torch.bfloat16


def test_registry_is_the_reference_registry():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    assert sorted(TC.ARCH_IDS) == sorted(JAX_ARCH_IDS)


def _pair(arch, dtype):
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, strip(jm.init(jax.random.key(3))))
    attn = jp["decoder"]["scanned"]["attn"]
    rng = np.random.default_rng(12)
    for name in _DRAWN:
        if name in attn:
            base = 1.0 if name.endswith("norm") else 0.0
            attn[name] = (base + 0.5 * rng.normal(size=attn[name].shape)
                          ).astype(attn[name].dtype)
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jp, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    return jm, jp, tm, tp


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run(arch, dtype, *, use_kernels, steps, tol, exact_streams):
    """Prefill a right-padded batch (true lengths 11 and 6 in 16), then
    greedy-decode ``steps`` tokens on both sides, each fed its own
    argmax."""
    jm, jp, tm, tp = _pair(arch, dtype)
    B, S, max_len = 2, 16, 40
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    true_len = np.array([11, 6], np.int32)
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


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "chameleon-34b"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_fp32_match_reference(arch, use_kernels):
    _run(arch, "float32", use_kernels=use_kernels, steps=6,
         tol=FP32_LOGIT_TOL, exact_streams=True)


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "chameleon-34b"])
def test_prefill_and_decode_bf16_within_tolerance(arch):
    _run(arch, "bfloat16", use_kernels=True, steps=6, tol=BF16_LOGIT_TOL,
         exact_streams=False)


@pytest.mark.parametrize("arch,names", [
    ("qwen1.5-110b", ("bq", "bk", "bv")), ("chameleon-34b", ("q_norm",
                                                             "k_norm"))])
def test_bridge_carries_bias_and_qk_norm(arch, names):
    """The drawn leaves reach the port: biases in the activation dtype,
    QK-norm scales in fp32, as the reference computes the norms."""
    jm, jp, tm, tp = _pair(arch, "bfloat16")
    attn = tp["decoder"]["layers"][1]["attn"]
    for name in names:
        want = np.asarray(jp["decoder"]["scanned"]["attn"][name][1],
                          np.float32)
        got = attn[name]
        assert got.dtype == (torch.float32 if name.endswith("norm")
                             else torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                                   atol=1e-2)
        assert not np.allclose(want, want.flat[0])
