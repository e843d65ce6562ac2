"""The scan backward as the host plans it, and its order of arithmetic.

- ``scan_bwd_plan`` at falcon-mamba-7b's (B 4, d_in 8192, N 16) and
  hymba-1.5b's (B 2, d_in 3200, N 16) training layers: at least 12
  resident warps an SM by its own occupancy arithmetic, shared memory
  within the 227 KB a block may have, a grid whose cluster size divides
  it, and a dB/dC partial buffer at least 4x smaller than one partial per
  block of 32 channels.  Over a sweep of d_in up to 8192, every channel
  is taken by exactly one block and only the padding to whole clusters is
  idle.  The residency mirrors the kernel: the shared memory's count, at
  most 4, which the launch bounds ask of the registers too.
- ``selective_scan_bwd_split_ref``, the plain version in the kernel's
  order (sub-chunks recomputed from their starts; dB and dC summed by
  block, by cluster in rank order, then over the clusters' partials),
  against ``selective_scan_bwd_ref`` and ``jax.vjp`` of the reference's
  ``fused_selective_scan`` on the CPU: N 4/8/16, S 1, 7, 33 and 100
  (none a multiple of the 8-step sub-chunk but 1's edge), d_in no multiple
  of the channels per block or the cluster, fp32 within 1e-5 of each
  tensor's largest magnitude (summation order and 2^(dt A log2 e) for
  exp(dt A) only), as ``test_torch_train_ssm.py`` holds the plain pair.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    SCAN_CHUNK, selective_scan_bwd_ref, selective_scan_bwd_split_ref,
    selective_scan_fwd_ref)

SMS = 132
SCAN_TOL = 1e-5
BLOCK_SMEM_MAX = 232448          # 227 KB: the most one block may ask for
PARENT_CHANNELS = 32             # one partial per 32 channels at N 16
TRAIN_SHAPES = {"falcon-mamba-7b": (4, 8192, 16),
                "hymba-1.5b": (2, 3200, 16)}
NAMES = ("dx", "ddt", "db", "dc", "dA", "dD")


@pytest.mark.parametrize("es", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("arch", sorted(TRAIN_SHAPES))
def test_plan_at_training_shapes(arch, es):
    B, D, N = TRAIN_SHAPES[arch]
    p = ops.scan_bwd_plan(B, D, N, SMS, es)
    assert p.warps >= 12
    assert p.warps == p.resident * 256 // 32
    assert p.smem == ops.scan_bwd_smem(N, es) <= BLOCK_SMEM_MAX
    assert p.grid_x % p.cluster == 0 and 1 <= p.cluster <= 8
    assert p.clusters * p.cluster == p.grid_x
    assert p.sub == 8 and SCAN_CHUNK % p.sub == 0
    # (B, clusters, S, 2N) fp32 against one partial per 32-channel block
    assert 4 * p.clusters <= -(-D // PARENT_CHANNELS)
    # per warp, no more shared memory than a 4-warp block of 56 KB
    assert p.smem // (256 // 32) <= 56 * 1024 // 4


# clusters of 1, 2, 4 and 8 blocks an H100 holds at once (the occupancy
# calculator's, for the bf16 instance at N 16: 2 blocks an SM)
H100_SLOTS = (264, 132, 62, 30)


@pytest.mark.parametrize("slots", [None, H100_SLOTS], ids=["model", "h100"])
def test_plan_at_falcon_and_hymba(slots):
    """Falcon's 512 blocks take 2 waves of 264 slots; in clusters of 8 or
    4 they would take 3 (64 of 30, 128 of 62), so clusters of 2.  Hymba's
    100 take one, so clusters of 8, each row padded from 50 to 56."""
    falcon = ops.scan_bwd_plan(4, 8192, 16, SMS, 2, slots)
    hymba = ops.scan_bwd_plan(2, 3200, 16, SMS, 2, slots)
    assert (falcon.channels, falcon.blocks, falcon.cluster,
            falcon.clusters, falcon.waves) == (64, 128, 2, 64, 2)
    assert (hymba.blocks, hymba.cluster, hymba.grid_x, hymba.clusters,
            hymba.waves) == (50, 8, 56, 7, 1)
    assert (falcon.warps, hymba.warps) == (16, 16)


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("D", [1, 7, 16, 80, 100, 129, 2080, 100 * 32,
                               3200, 5900, 8191, 8192])
def test_plan_takes_every_channel_once(D, N):
    for B in (1, 2, 4):
        p = ops.scan_bwd_plan(B, D, N, SMS)
        assert p.channels == 256 * 4 // N
        assert p.blocks == -(-D // p.channels)
        assert p.grid_x % p.cluster == 0
        assert 0 <= p.grid_x - p.blocks < p.cluster
        taken = np.zeros(D, dtype=np.int64)
        for blk in range(p.grid_x):
            c0 = blk * p.channels
            if c0 >= D:
                continue        # padding to a whole cluster: idle
            taken[c0:min(D, c0 + p.channels)] += 1
        assert (taken == 1).all()


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_residency_is_the_shared_memory(N, es):
    """The blocks an SM holds are the shared memory's count, at most 2
    (16 of the SM's 64 warps) at N 16 and 1 below: the launch bounds ask
    the registers for the same count, so they never bind first."""
    smem = ops.scan_bwd_smem(N, es)
    by_smem = ops._SM_SMEM // (smem + ops._BLOCK_SMEM)
    assert smem <= BLOCK_SMEM_MAX
    assert ops.bwd_resident(N, es) == min(2 if N == 16 else 1, by_smem)
    assert ops.bwd_resident(N, es) >= 1


# ---------------------------------------------------------------------------
# the kernel's order of arithmetic, against the reference
# ---------------------------------------------------------------------------

def _scan_inputs(B, S_len, D, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S_len, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S_len, D)) - 1.0)).astype(
        np.float32)
    b = rng.normal(size=(B, S_len, N)).astype(np.float32)
    c = rng.normal(size=(B, S_len, N)).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32), (D, 1)))
    d = rng.normal(size=(D,)).astype(np.float32)
    gy = rng.normal(size=(B, S_len, D)).astype(np.float32)
    return x, dt, b, c, a_log, d, gy


def _jax_grads(ins):
    """jax.vjp of the reference's fused scan at the largest chunk up to
    32 that divides S (the gradients do not depend on the chunk)."""
    x, dt, b, c, a_log, d, gy = ins
    S_len = x.shape[1]
    chunk = max(k for k in range(1, SCAN_CHUNK + 1) if S_len % k == 0)
    args = tuple(jnp.asarray(t) for t in (x, dt, b, c, -np.exp(a_log), d))
    _, vjp = jax.vjp(
        lambda *a: JS.fused_selective_scan(*a, chunk, False), *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(gy))]


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= SCAN_TOL * scale, (what, err, scale)


# (B, D, channels, cluster): 19 channels in blocks of 4 and clusters of 3
# (5 blocks: the last part full, one idle block)
SPLITS = [(2, 19, 4, 3)]


@pytest.mark.parametrize("S_len", [1, 7, 33, 100])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_split_ref_matches_reference(N, S_len):
    B, D, channels, cluster = SPLITS[0]
    ins = _scan_inputs(B, S_len, D, N, seed=S_len * N)
    t = [torch.tensor(a) for a in ins]
    _, bounds = selective_scan_fwd_ref(*t[:6])
    got = selective_scan_bwd_split_ref(*t[:6], bounds, t[6],
                                       channels=channels, cluster=cluster)
    plain = selective_scan_bwd_ref(*t[:6], bounds, t[6])
    for name, g, w in zip(NAMES, got, plain):
        _close(g, w, name)
    for name, g, w in zip(NAMES, got, _jax_grads(ins)):
        _close(g, w, name)


def test_split_ref_at_the_plans_cut():
    """(2, 600, N 16) as the plan cuts it: 10 blocks of 64 channels in
    clusters of 8, the second padded by 6 idle blocks."""
    B, S_len, D, N = 2, 45, 600, 16
    p = ops.scan_bwd_plan(B, D, N, SMS)
    assert (p.channels, p.cluster, p.grid_x - p.blocks) == (64, 8, 6)
    ins = _scan_inputs(B, S_len, D, N, seed=3)
    t = [torch.tensor(a) for a in ins]
    _, bounds = selective_scan_fwd_ref(*t[:6])
    got = selective_scan_bwd_split_ref(*t[:6], bounds, t[6],
                                       channels=p.channels,
                                       cluster=p.cluster, sub=p.sub)
    for name, g, w in zip(NAMES, got, _jax_grads(ins)):
        _close(g, w, name)
