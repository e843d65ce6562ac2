"""Port parity: configs, norms, RoPE, activations, the dense FFN and the
plain attention functions of ``repro_torch`` against the JAX package, on
the same numpy inputs.

Tolerances: fp32 legs compare to 1e-5 (the two frameworks differ only in
summation order and libm); bf16 legs to 2**-7 relative, two bf16 ulps,
because XLA may fuse elementwise ops in fp32 where PyTorch rounds each.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402

RNG = np.random.default_rng(7)
FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def _close(jax_out, torch_out, tol):
    a = _np(jax_out)
    b = torch_out.float().numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b",
                                  "falcon-mamba-7b", "deepseek-v2-lite-16b",
                                  "arctic-480b"])
def test_configs_match_reference(arch):
    for get_t, get_j in ((TC.get_config, jax_get_config),
                         (TC.get_reduced, jax_get_reduced)):
        ct, cj = get_t(arch), get_j(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.param_count() == cj.param_count()
        assert ct.padded_vocab == cj.padded_vocab
        assert ct.resolved_head_dim == cj.resolved_head_dim
        assert ct.attention_free == cj.attention_free
    assert TC.get_reduced(arch).activation_dtype == torch.bfloat16
    full = TC.get_config("minitron-4b")
    assert 4.1e9 < full.param_count() < 4.3e9


def test_unknown_arch_and_later_slices_raise():
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")
    cfg = TC.get_reduced("minitron-4b")
    # an SSM encoder has no slice; SSM layers, hybrid layers (ported with
    # hymba), a dense encoder-decoder, MoE and MLA (ported with
    # deepseek-v2-lite) are all taken
    for field, value in (("ssm", TC.SSMConfig()),
                         ("hybrid_parallel", True),
                         ("moe", TC.MoEConfig(4, 2, 32)),
                         ("mla", TC.MLAConfig())):
        check_supported(dataclasses.replace(cfg, **{field: value}))
    with pytest.raises(NotImplementedError, match="slice"):
        check_supported(dataclasses.replace(TC.get_reduced("falcon-mamba-7b"),
                                            encoder_layers=2))
    check_supported(TC.get_reduced("falcon-mamba-7b"))
    check_supported(TC.get_reduced("seamless-m4t-medium"))


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    x = RNG.normal(size=(2, 5, 32)) * 3.0
    scale = RNG.normal(size=(32,))
    bias = RNG.normal(size=(32,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    _close(JL.rms_norm(_j(x, jd), _j(scale)),
           TL.rms_norm(_t(x, td), _t(scale)), tol)
    _close(JL.layer_norm(_j(x, jd), _j(scale), _j(bias)),
           TL.layer_norm(_t(x, td), _t(scale), _t(bias)), tol)
    _close(JL.apply_norm("rmsnorm", {"scale": _j(scale)}, _j(x, jd), 1e-5),
           TL.apply_norm("rmsnorm", {"scale": _t(scale)}, _t(x, td), 1e-5),
           tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    x = RNG.normal(size=(2, 7, 3, 16))
    pos = RNG.integers(0, 500, size=(2, 7))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    _close(JL.rope_freqs(16, 10000.0), TL.rope_freqs(16, 10000.0), FP32_TOL)
    _close(JL.apply_rope(_j(x, jd), jnp.asarray(pos), 1e6),
           TL.apply_rope(_t(x, td), torch.from_numpy(pos), 1e6), tol)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "relu2"])
def test_activations(name):
    x = RNG.normal(size=(4, 33)) * 2.0
    _close(JL.activation(name)(_j(x)), TL.activation(name)(_t(x)), FP32_TOL)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn(arch, dtype):
    jcfg = jax_get_reduced(arch)
    tcfg = TC.get_reduced(arch)
    p = {k: np.asarray(v.value) for k, v in
         JM.ffn_init(jax.random.key(3), jcfg, jcfg.d_ff).items()}
    x = RNG.normal(size=(2, 3, jcfg.d_model))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = JM.ffn_apply({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                        _j(x, jd))
    got = TM.ffn_apply({k: _t(v, td) for k, v in p.items()}, tcfg, _t(x, td))
    scale = float(np.abs(_np(want)).max())
    tol = FP32_TOL if dtype == "float32" else 4 * BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("window,cap,glob", [(0, 0.0, None), (5, 0.0, False),
                                             (5, 20.0, True), (0, 15.0, None)])
def test_decode_attention(window, cap, glob):
    B, T, Hq, Hkv, D = 3, 24, 4, 2, 16
    q = RNG.normal(size=(B, 1, Hq, D))
    k = RNG.normal(size=(B, T, Hkv, D))
    v = RNG.normal(size=(B, T, Hkv, D))
    lens = np.array([1, 13, 24], np.int32)
    kw = dict(window=window, logit_cap=cap, is_global=glob)
    _close(JL.decode_attention(_j(q), _j(k), _j(v), jnp.asarray(lens), **kw),
           TL.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(lens),
                               **kw), FP32_TOL)


@pytest.mark.parametrize("S,block", [(37, 512), (37, 16)])
@pytest.mark.parametrize("window,cap,glob", [(0, 0.0, None), (9, 0.0, False),
                                             (9, 25.0, True)])
def test_blockwise_attention(S, block, window, cap, glob):
    B, Hq, Hkv, D = 2, 4, 2, 16
    q = RNG.normal(size=(B, S, Hq, D))
    k = RNG.normal(size=(B, S, Hkv, D))
    v = RNG.normal(size=(B, S, Hkv, D))
    kw = dict(causal=True, window=window, logit_cap=cap, is_global=glob,
              block_size=block)
    _close(JL.blockwise_attention(_j(q), _j(k), _j(v), **kw),
           TL.blockwise_attention(_t(q), _t(k), _t(v), **kw), FP32_TOL)


def test_blockwise_attention_bf16():
    B, S, Hq, Hkv, D = 1, 40, 4, 2, 16
    q, k, v = (RNG.normal(size=(B, S, h, D)) for h in (Hq, Hkv, Hkv))
    want = JL.blockwise_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                  _j(v, jnp.bfloat16), causal=True)
    got = TL.blockwise_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                 _t(v, torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    _close(want, got, 2 * BF16_TOL)


def test_scatter_kv_in_place_and_clamped():
    cache = torch.zeros((3, 6, 2, 4))
    new = torch.arange(3 * 2 * 4, dtype=torch.float32).reshape(3, 1, 2, 4)
    pos = torch.tensor([0, 5, 9], dtype=torch.int32)
    out = TL.scatter_kv(cache, new, pos)
    assert out is cache
    want = JL.scatter_kv(jnp.zeros((3, 6, 2, 4)), jnp.asarray(new.numpy()),
                         jnp.asarray(pos.numpy()))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))
