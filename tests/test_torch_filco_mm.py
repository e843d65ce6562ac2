"""The port's filco_mm plain versions (``repro_torch.kernels.filco_mm``)
against the JAX package: its Pallas kernels in interpret mode and its jnp
oracle, on the same numpy inputs.  The wrappers take the plain version on
CPU tensors, so these run here; the CUDA kernels are held against the same
plain versions on the card (``tests/test_torch_kernels_gpu.py``).

Tolerances as the reference's own kernel tests: fp32 1e-4 (summation
order), bf16 6e-2 (bf16 outputs of O(10) values rounded at other points),
relative with an absolute floor of 32x.  The kernel's fp32 arithmetic
(3xTF32, ``flex_mm_3xtf32_ref``) is held to 1e-5 of the largest |value|
at the paper path's pass shapes: fp32's own error there is about 5e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.filco_mm import kernel as jfm  # noqa: E402
from repro.kernels.filco_mm import ref as jref  # noqa: E402
from repro_torch.kernels.filco_mm import ops as fm  # noqa: E402
from repro_torch.kernels.filco_mm.ref import (  # noqa: E402
    flex_mm_3xtf32_ref, flex_mm_ref, static_mm_ref, tf32_round)

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
    """The port's atom is the kernel's staged block step at the plan's
    tile for the buffer: live tiles, ceil-padded per axis, splits not
    counted; flexible never exceeds static.  A window that is the pass, as
    in the simulator, is counted at the plan for the pass."""
    ceil = lambda x, a: -(-x // a)
    buf = (256, 256, 384)
    bm, bn, bk, _ = fm.plan(*buf)
    assert fm.atoms_issued_flexible(8, 24, 16, buf=buf) == 1
    assert fm.atoms_issued_flexible(129, 33, 65, buf=buf) \
        == ceil(129, bm) * ceil(33, bk) * ceil(65, bn)
    assert fm.atoms_issued_flexible(8, 24, 16, buf=buf) \
        < fm.atoms_issued_static(*buf) \
        == fm.atoms_issued_flexible(256, 256, 384, buf=buf) \
        == ceil(256, bm) * ceil(256, bk) * ceil(384, bn)
    bm, bn, bk, _ = fm.plan(16, 768, 768)
    assert fm.atoms_issued_flexible(16, 768, 768) \
        == ceil(16, bm) * ceil(768, bk) * ceil(768, bn)
    # an explicit tile, one atom per staged step of it
    assert fm.atoms_issued_flexible(129, 9, 128, bm=128, bk=8, bn=128) \
        == 2 * 2 * 1


# BERT-128's CU passes on the paper path (m, k, n): the port's DSE with
# the example's settings gives 309 passes in these 18 shapes
BERT128_PASS_SHAPES = (
    (16, 768, 768), (16, 768, 3072), (16, 3072, 768), (32, 768, 768),
    (32, 3072, 768), (64, 768, 768), (64, 768, 3072), (64, 3072, 768),
    (128, 768, 768), (128, 768, 3072), (128, 3072, 768), (192, 128, 64),
    (384, 64, 128), (384, 128, 64), (768, 64, 128), (768, 128, 64),
    (1536, 64, 128), (1536, 128, 64))


def _ddr_operands(rng, m, k, n):
    """fp32 operands scaled as the DDR image scales them: the input
    N(0, 1), the weight N(0, 1) / sqrt(k)."""
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return a, b


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("mkn,tile", [
    ((16, 768, 768), (16, 128, 128)), ((128, 3072, 768), (128, 128, 128)),
    ((64, 768, 3072), (64, 128, 128)), ((192, 128, 64), (64, 64, 64)),
])
def test_flex_mm_3xtf32_spec_matches_jax_and_fp64(mkn, tile):
    """The kernel's fp32 arithmetic at the plan's splits, against the JAX
    Pallas kernel (interpret mode) and against fp64, within 1e-5 of the
    largest |value|, in the whole valid region and with runtime dims
    inside the buffer."""
    rng = np.random.default_rng(21)
    m, k, n = mkn
    a, b = _ddr_operands(rng, m, k, n)
    bm, bn, bk, splits = fm.plan(m, k, n)
    for dims in (mkn, (m - 3, k - 40, n - 5)):
        got = flex_mm_3xtf32_ref(torch.from_numpy(a), torch.from_numpy(b),
                                 list(dims), bk=bk, splits=splits).numpy()
        jm, jb, jn = tile
        kern = jfm.flex_mm(jnp.asarray(a), jnp.asarray(b),
                           jnp.asarray(dims, jnp.int32), bm=jm, bk=jb,
                           bn=jn, interpret=True)
        assert _rel(got, kern) <= 1e-5
        dm, dk, dn = dims
        want = np.zeros((m, n))
        want[:dm, :dn] = a[:dm, :dk].astype(np.float64) \
            @ b[:dk, :dn].astype(np.float64)
        assert _rel(got, want) <= 1e-5
        assert (got[dm:] == 0).all() and (got[:, dn:] == 0).all()


def test_one_tf32_product_misses_the_path_tolerance():
    """Why the kernel takes three TF32 products for fp32: one TF32 product
    (both operands rounded to TF32, exact sums) is more than 1e-4 of the
    largest |value| off at (128, 3072, 768), the tolerance the paper path
    holds every layer to; three are within 1e-5."""
    rng = np.random.default_rng(22)
    a, b = _ddr_operands(rng, 128, 3072, 768)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    one = tf32_round(ta).double() @ tf32_round(tb).double()
    assert _rel(one.numpy(), exact) > 1e-4
    three = flex_mm_3xtf32_ref(ta, tb, [128, 3072, 768])
    assert _rel(three.numpy(), exact) <= 1e-5


def test_tf32_round_is_round_to_nearest_ties_away():
    """cvt.rna.tf32.f32: 10 mantissa bits kept, the 13 dropped ones
    rounded to nearest with ties away from zero, the sign kept."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp + ulp / 2, 1 + ulp / 4,
                      -(1 + ulp / 2), 3.0, -0.0, 2.0 ** -130])
    want = [1.0, 1 + ulp, 1 + 2 * ulp, 1.0, -(1 + ulp), 3.0, -0.0,
            2.0 ** -130]
    got = tf32_round(x)
    assert got.tolist() == want
    assert torch.signbit(got[6])
    # head + tail represent an fp32 value to about 2**-22 of itself
    v = torch.from_numpy(np.random.default_rng(23).normal(
        size=4096).astype(np.float32))
    head = tf32_round(v)
    tail = tf32_round(v - head)
    assert ((head + tail - v).abs() <= v.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("splits", [1, 3, 12])
def test_flex_mm_3xtf32_spec_sums_splits_in_order(splits):
    """The splits partition the reduction and are summed in split order:
    the spec equals the left-to-right sum of its per-split products."""
    rng = np.random.default_rng(24)
    a, b = (torch.from_numpy(x) for x in _ddr_operands(rng, 16, 768, 768))
    got = flex_mm_3xtf32_ref(a, b, [16, 700, 768], splits=splits)
    kspan = fm.split_span(768, 32, splits)
    a = torch.where(torch.arange(768) < 700, a, 0.0)
    a_h, b_h = tf32_round(a), tf32_round(b)
    a_t, b_t = tf32_round(a - a_h), tf32_round(b - b_h)
    want = torch.zeros(16, 768)
    for s in range(splits):
        ks = slice(s * kspan, (s + 1) * kspan)
        want = want + (a_t[:, ks] @ b_h[ks] + a_h[:, ks] @ b_t[ks]
                       + a_h[:, ks] @ b_h[ks])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


PLAN_BUFFERS = BERT128_PASS_SHAPES + (
    (2048, 2048, 2048), (256, 256, 384), (192, 192, 192), (300, 200, 400),
    (1, 1, 1), (0, 7, 9), (5, 0, 3), (16, 768, 37), (4096, 8, 4096),
    (8, 100000, 8), (1040, 1032, 2040))


@pytest.mark.parametrize("buf", PLAN_BUFFERS)
def test_plan_tile_covers_buffer_and_splits_partition_k(buf):
    """The grid of (bm, bn) tiles covers the output buffer, the tile is a
    compiled instance, and the splits cut Kx into whole-bk spans, each
    non-empty, that cover it once."""
    Mx, Kx, Nx = buf
    bm, bn, bk, splits = fm.plan(*buf)
    assert (bm, bn) in fm.TILES and bk == fm.TILE_K
    gx, gy, gz = fm.grid(Mx, Nx, bm, bn, splits)
    assert gx * bn >= Nx and gy * bm >= Mx and gz == splits
    assert (gx - 1) * bn < max(Nx, 1) and (gy - 1) * bm < max(Mx, 1)
    kspan = fm.split_span(Kx, bk, splits)
    assert kspan % bk == 0
    spans = [(s * kspan, min((s + 1) * kspan, Kx)) for s in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == Kx
    assert all(lo < hi for lo, hi in spans) or Kx == 0
    assert all(spans[i][1] == spans[i + 1][0] for i in range(splits - 1))


def test_plan_depends_on_the_buffer_extents_only():
    """The plan is a function of (Mx, Kx, Nx) and the card's SMs: it takes
    no dims, and every call for one buffer gives one plan."""
    import inspect
    assert list(inspect.signature(fm.plan).parameters) == [
        "Mx", "Kx", "Nx", "sms"]
    fm.plan.cache_clear()
    first = [fm.plan(*buf) for buf in PLAN_BUFFERS]
    fm.plan.cache_clear()
    assert [fm.plan(*buf) for buf in reversed(PLAN_BUFFERS)][::-1] == first


@pytest.mark.parametrize("mkn", BERT128_PASS_SHAPES)
def test_plan_fills_the_card_at_every_bert128_pass(mkn):
    """Every BERT-128 pass shape launches at least one full wave of 132
    blocks on the H100 (a fixed 128x128 tile gave 2-24)."""
    m, k, n = mkn
    bm, bn, _, splits = fm.plan(m, k, n, 132)
    gx, gy, gz = fm.grid(m, n, bm, bn, splits)
    assert gx * gy * gz >= 132
    assert bm <= max(16, m) and bn <= max(16, n)


def test_wrapper_raises_on_a_non_cpu_tensor_it_cannot_run():
    """Only a CPU tensor takes the plain version: a ``meta`` tensor (the
    dry run's) has no data to run on, and is taken only under an
    ``opcount`` counter, which gets the work and an output of the shape;
    outside one it raises."""
    from repro_torch.analysis import opcount
    a = torch.empty((4, 4), device="meta")
    dims = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="outside an OpCounter"):
        fm.flex_mm(a, a, dims)
    with pytest.raises(RuntimeError, match="outside an OpCounter"):
        fm.static_mm(a, a)
    out, cost = opcount.count(fm.static_mm, a, a)
    assert out.shape == (4, 4) and out.device.type == "meta"
    assert cost.kernels == {"static_mm": [1, 2 * 4 ** 3, 3 * 16 * 4]}
