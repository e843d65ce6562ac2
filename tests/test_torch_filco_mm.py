"""The port's filco_mm plain versions (``repro_torch.kernels.filco_mm``)
against the JAX package: its Pallas kernels in interpret mode and its jnp
oracle, on the same numpy inputs.  The wrappers take the plain version on
CPU tensors, so these run here; the CUDA kernels are held against the same
plain versions on the card (``tests/test_torch_kernels_gpu.py``).

Tolerances as the reference's own kernel tests: fp32 1e-4 (summation
order), bf16 6e-2 (bf16 outputs of O(10) values rounded at other points),
relative with an absolute floor of 32x.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.filco_mm import kernel as jfm  # noqa: E402
from repro.kernels.filco_mm import ref as jref  # noqa: E402
from repro_torch.kernels.filco_mm import ops as fm  # noqa: E402
from repro_torch.kernels.filco_mm.ref import (flex_mm_ref,  # noqa: E402
                                              static_mm_ref)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 6e-2)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    x = jnp.asarray(rng.normal(size=shape), jd)
    return x, torch.tensor(np.asarray(x.astype(jnp.float32))).to(td)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("mkn", [
    (256, 256, 384), (100, 200, 300), (8, 24, 16), (1, 1, 1),
    (130, 129, 257), (64, 64, 64), (255, 1, 255),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flex_mm_plain_matches_jax_kernel_and_oracle(mkn, dtype):
    rng = np.random.default_rng(7)
    ja, ta = _pair(rng, (256, 256), dtype)
    jb, tb = _pair(rng, (256, 384), dtype)
    dims = jnp.asarray(mkn, jnp.int32)
    got = fm.flex_mm(ta, tb, torch.tensor(mkn, dtype=torch.int32))
    assert got.dtype == ta.dtype and got.shape == (256, 384)
    tol = DTYPES[dtype][2]
    kern = jfm.flex_mm(ja, jb, dims, bm=64, bk=64, bn=128, interpret=True)
    oracle = jref.flex_mm_ref(ja, jb, dims)
    for want in (kern, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol * 32)


@pytest.mark.parametrize("seed", range(6))
def test_flex_mm_plain_random_dims_one_buffer(seed):
    """One buffer serves every (m, k, n) <= its shape."""
    rng = np.random.default_rng(100 + seed)
    m, k, n = (int(x) for x in rng.integers(1, 193, size=3))
    ja, ta = _pair(rng, (192, 192), "float32")
    jb, tb = _pair(rng, (192, 192), "float32")
    got = fm.flex_mm(ta, tb, [m, k, n])
    want = jref.flex_mm_ref(ja, jb, jnp.asarray([m, k, n], jnp.int32))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_flex_mm_plain_zero_outside_valid_region_in_place():
    a = torch.ones((128, 128))
    b = torch.ones((128, 128))
    out = torch.full((128, 128), float("nan"))
    before = fm.launches
    got = fm.flex_mm(a, b, torch.tensor([40, 50, 60], dtype=torch.int32),
                     out=out)
    assert got is out and fm.launches == before      # plain path, no launch
    assert (out[40:, :] == 0).all() and (out[:, 60:] == 0).all()
    assert (out[:40, :60] == 50.0).all()
    jout = jfm.flex_mm(jnp.ones((128, 128)), jnp.ones((128, 128)),
                       jnp.asarray([40, 50, 60], jnp.int32), bm=64, bk=64,
                       bn=64, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_flex_mm_plain_masks_nan_in_both_paddings():
    """NaN or Inf beyond k in A and in B never reaches the output (the
    oracle's masking; the Pallas kernel masks only A)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(96, 80)).astype(np.float32))
    m, k, n = 50, 70, 60
    clean = flex_mm_ref(a, b, [m, k, n])
    a[:, k:] = float("nan")
    a[m:, :] = float("inf")
    b[k:, :] = float("nan")
    b[:, n:] = float("-inf")
    got = fm.flex_mm(a, b, torch.tensor([m, k, n], dtype=torch.int32))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)
    torch.testing.assert_close(got[:m, :n], a[:m, :k] @ b[:k, :n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_mm_plain_matches_jax(dtype):
    rng = np.random.default_rng(11)
    ja, ta = _pair(rng, (128, 192), dtype)
    jb, tb = _pair(rng, (192, 64), dtype)
    got = fm.static_mm(ta, tb)
    tol = DTYPES[dtype][2]
    for want in (jfm.static_mm(ja, jb, bm=64, bk=64, bn=64, interpret=True),
                 jref.static_mm_ref(ja, jb)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol * 32)
    torch.testing.assert_close(got, static_mm_ref(ta, tb))


@pytest.mark.parametrize("mkn", [(8, 24, 16), (256, 256, 384), (1, 1, 1),
                                 (130, 129, 257), (1000, 3, 129)])
def test_atoms_at_the_reference_tile_equal_jax(mkn):
    ref_tile = dict(bm=128, bk=128, bn=128)
    assert fm.atoms_issued_flexible(*mkn, atom=(8, 128, 128), **ref_tile) \
        == jfm.atoms_issued_flexible(*mkn, **ref_tile)
    assert fm.atoms_issued_static(*mkn, atom=(8, 128, 128), **ref_tile) \
        == jfm.atoms_issued_static(*mkn, **ref_tile)


def test_atoms_at_the_cuda_tile():
    """The port's atom is the kernel's staged block step (128, 8, 128):
    live tiles, ceil-padded per axis; flexible never exceeds static."""
    assert fm.atoms_issued_flexible(8, 24, 16) == 1 * 3 * 1
    assert fm.atoms_issued_flexible(129, 9, 128) == 2 * 2 * 1
    assert fm.atoms_issued_flexible(8, 24, 16) \
        < fm.atoms_issued_static(256, 256, 384) \
        == fm.atoms_issued_flexible(256, 256, 384) == 2 * 32 * 3


def test_wrapper_raises_on_a_non_cpu_tensor_it_cannot_run():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's checks, which refuse what is not on a CUDA device."""
    a = torch.empty((4, 4), device="meta")
    dims = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fm.flex_mm(a, a, dims)
    with pytest.raises(ValueError, match="CUDA device"):
        fm.static_mm(a, a)
