"""Port parity for MLA (multi-head latent attention): the port's
``mla_fwd``, ``mla_prefill`` and the absorbed ``mla_step`` against
``repro.models.attention`` on deepseek-v2-lite-reduced, with a full-rank q
(the published lite model) and a low-rank q (``q_lora_rank`` > 0), the
JAX init's weights carried over.

fp32: outputs and the cached latents within 1e-5 of the largest |value|;
the decode step's bounded latent read (``kv_bound``) equal to the padded
read.  The flash kernel's wrapper takes MLA's head dims: the prefill runs
it at the qk dim (24 here, 192 at full width), on the CPU through its
plain version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

TOL = 1e-5
QRANKS = (0, 16)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _setup(q_lora_rank, seed=0):
    jcfg = dataclasses.replace(jax_get_reduced("deepseek-v2-lite-16b"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_reduced("deepseek-v2-lite-16b"),
                               dtype="float32")
    jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
        jcfg.mla, q_lora_rank=q_lora_rank))
    tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(
        tcfg.mla, q_lora_rank=q_lora_rank))
    jp = strip(JA.mla_init(jax.random.key(seed), jcfg))
    return jcfg, tcfg, jp, _to_torch(jp)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("q_lora_rank", QRANKS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_mla_fwd_matches_reference(q_lora_rank, use_kernels):
    jcfg, tcfg, jp, tp = _setup(q_lora_rank)
    B, S = 2, 13
    x = _x(jcfg, B, S)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = JA.mla_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = TA.mla_fwd(tp, tcfg, torch.from_numpy(x), torch.from_numpy(
        pos.copy()), use_kernels=use_kernels)
    assert got.shape == (B, S, jcfg.d_model)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("q_lora_rank", QRANKS)
def test_mla_prefill_writes_the_reference_latents(q_lora_rank):
    jcfg, tcfg, jp, tp = _setup(q_lora_rank)
    B, S, T = 2, 11, 32
    x = _x(jcfg, B, S, seed=2)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jy, jc = JA.mla_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                            strip(JA.mla_cache_init(jcfg, B, T,
                                                    jnp.float32)))
    cache = TA.mla_cache_init(tcfg, B, T, torch.float32, "cpu")
    ty, tc = TA.mla_prefill(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), cache)
    assert tc["ckv"] is cache["ckv"]                  # written in place
    assert tc["ckv"].shape == (B, T, tcfg.mla.kv_lora_rank)
    assert tc["krope"].shape == (B, T, tcfg.mla.qk_rope_head_dim)
    assert _rel(ty, jy) <= TOL
    for name in ("ckv", "krope"):
        assert _rel(tc[name], jc[name]) <= TOL
        assert bool((tc[name][:, S:] == 0).all())


@pytest.mark.parametrize("q_lora_rank", QRANKS)
@pytest.mark.parametrize("kv_bound", [None, 32])
def test_mla_step_matches_reference(q_lora_rank, kv_bound):
    """Prefill rows of true lengths 9 and 4, then three absorbed decode
    steps at per-row positions; with ``kv_bound`` (and kernels on, as the
    engine threads it) the latent read stops at row 32 of 40."""
    jcfg, tcfg, jp, tp = _setup(q_lora_rank)
    B, S, T = 2, 9, 40
    x = _x(jcfg, B, S, seed=3)
    pos = np.broadcast_to(np.arange(S), (B, S))
    _, jc = JA.mla_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           strip(JA.mla_cache_init(jcfg, B, T, jnp.float32)))
    _, tc = TA.mla_prefill(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()),
                           TA.mla_cache_init(tcfg, B, T, torch.float32,
                                             "cpu"))
    p = np.array([9, 4], np.int32)
    for step in range(3):
        x1 = _x(jcfg, B, 1, seed=10 + step)
        jy, jc = JA.mla_step(jp, jcfg, jnp.asarray(x1), jc, jnp.asarray(p),
                             use_kernels=kv_bound is not None,
                             kv_bound=kv_bound)
        ty, tc = TA.mla_step(tp, tcfg, torch.from_numpy(x1), tc,
                             torch.from_numpy(p.copy()),
                             use_kernels=kv_bound is not None,
                             kv_bound=kv_bound)
        assert ty.shape == (B, 1, jcfg.d_model)
        assert _rel(ty, jy) <= TOL, step
        for name in ("ckv", "krope"):
            assert _rel(tc[name], jc[name]) <= TOL
        p = p + 1


def test_mla_step_bounded_read_equals_padded_read():
    _, tcfg, _, tp = _setup(0)
    B, T = 3, 64
    cache = TA.mla_cache_init(tcfg, B, T, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(4)
    for name in ("ckv", "krope"):
        cache[name][:, :20] = torch.randn(cache[name][:, :20].shape,
                                          generator=gen)
    x1 = torch.randn((B, 1, tcfg.d_model), generator=gen)
    pos = torch.tensor([19, 3, 11], dtype=torch.int32)
    c2 = {k: v.clone() for k, v in cache.items()}
    full, _ = TA.mla_step(tp, tcfg, x1, cache, pos)
    bounded, _ = TA.mla_step(tp, tcfg, x1, c2, pos, use_kernels=True,
                             kv_bound=32)
    assert torch.allclose(full, bounded, rtol=1e-6, atol=1e-7)
    assert all(torch.equal(cache[k], c2[k]) for k in cache)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b"])
def test_flash_wrapper_takes_mla_head_dims(arch):
    """The qk dims MLA's prefill hands the flash kernel: 192 at full
    width, 24 reduced (48-byte bf16 rows, once refused), and 256; rows
    must be whole 16-byte chunks, up to 256."""
    for cfg in (get_config(arch), get_reduced(arch)):
        D = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        assert fa.head_dim_supported(D, torch.bfloat16)
        assert fa.head_dim_supported(D, torch.float32)
    assert get_config(arch).mla.qk_nope_head_dim + \
        get_config(arch).mla.qk_rope_head_dim == 192
    for D, dt, ok in ((256, torch.bfloat16, True), (264, torch.bfloat16,
                                                     False),
                      (8, torch.bfloat16, True), (4, torch.bfloat16, False),
                      (4, torch.float32, True), (6, torch.float32, False),
                      (136, torch.float32, True)):
        assert fa.head_dim_supported(D, dt) == ok, (D, dt)


def test_mla_init_shapes():
    for q_lora_rank in QRANKS:
        _, tcfg, _, _ = _setup(q_lora_rank)
        m = tcfg.mla
        p = TA.mla_init(torch.Generator().manual_seed(0), tcfg,
                        dtype=torch.float32, device="cpu")
        H, d = tcfg.num_heads, tcfg.d_model
        dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
        assert p["w_uk"].shape == (m.kv_lora_rank, H, m.qk_nope_head_dim)
        assert p["wo"].shape == (H, m.v_head_dim, d)
        assert p["kv_norm"].dtype == torch.float32
        if q_lora_rank:
            assert p["w_uq"].shape == (q_lora_rank, H, dqk)
            assert "w_q" not in p
        else:
            assert p["w_q"].shape == (d, H, dqk)
            assert "w_dq" not in p
