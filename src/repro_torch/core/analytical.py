"""Analytical latency model for composed accelerators (paper §3, Fig. 6:
"DDR profiling results + platform information" -> per-layer latency table).

The model prices one MM layer (m, k, n) on an accelerator *design point*:

  compute   — atomic-op count / (CUs x AIEs x clock), with the FILCO
              flexible-parallelism (FP) flag deciding whether invalid padded
              atoms are issued (static designs compute whole fixed tiles);
  DDR       — operand/result traffic with classic tiled-MM reuse
              (A read ceil(n/Tn) times, B read ceil(m/Tm) times, C
              read+written per k-pass), with the FMV flag deciding whether
              transfers are padded to static buffer shapes and FMF deciding
              whether the on-chip capacity can be re-split between operands;
  streams   — on-chip FMU<->CU traffic at the stream bandwidth;
  total     — max(compute, ddr, stream) under double buffering + a fixed
              per-invocation launch overhead.

Baselines (CHARM-1/2/3, RSN) are specific design points of the same model —
exactly how the paper frames them (§1, Fig. 1).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.common.platform import PlatformProfile, VCK190


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    """A (sub-)accelerator design point."""

    name: str
    num_cus: int
    aies_per_cu: int
    onchip_elems: int                    # total FMU capacity (elements)
    num_fmus: int = 16
    # static designs: fixed on-chip buffer shapes (rows, cols) per operand
    buf_a: Optional[Tuple[int, int]] = None
    buf_b: Optional[Tuple[int, int]] = None
    buf_c: Optional[Tuple[int, int]] = None
    # fixed compute tile per CU pass (static designs); None = flexible
    tile: Optional[Tuple[int, int, int]] = None
    # FILCO feature flags
    fp: bool = False                     # flexible computation parallelism
    fmv: bool = False                    # flexible on-chip memory view
    fmf: bool = False                    # flexible memory functionality
    # RSN-style: memory units of a fixed shape, count assignable per operand
    mem_unit_shape: Optional[Tuple[int, int]] = None

    @property
    def fmu_capacity(self) -> int:
        return self.onchip_elems // self.num_fmus


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    compute_s: float
    ddr_s: float
    stream_s: float
    launch_s: float
    total_s: float
    flops_valid: float
    flops_issued: float
    ddr_bytes: float
    num_fmus: int
    num_cus: int

    @property
    def compute_efficiency(self) -> float:
        return self.flops_valid / max(self.flops_issued, 1.0)


LAUNCH_OVERHEAD_S = 2.0e-6        # instruction decode + stream setup per pass
# VLIW/MXU pipeline fill per tile pass — calibrated so the single-engine
# efficiency curve matches the paper's Fig. 8 (<=5% loss at 14x24x16, i.e.
# ~2 atoms of fill against 42 issued atoms); DESIGN.md §8.
PIPELINE_FILL_ATOMS = 2


def _onchip_tiles(cfg: AccelConfig, m: int, k: int, n: int,
                  dtype_bytes: int) -> Tuple[int, int, int]:
    """On-chip macro-tile (Tm, Tk, Tn) governing DDR reuse."""
    cap = cfg.onchip_elems
    if cfg.fmf:
        # FMF: re-split the whole arena to the operand aspect (with FMV the
        # transfers are also exact; without it they stay quantized to the
        # chosen tile shapes).  Heuristic: clamp each dim, shrink the
        # largest until A+B+C fits (Fig. 5b).
        tm, tk, tn = min(m, 1024), min(k, 1024), min(n, 1024)
        while tm * tk + tk * tn + tm * tn > cap:
            # shrink the largest tile dim
            if tm >= tk and tm >= tn:
                tm = max(tm // 2, 8)
            elif tn >= tk:
                tn = max(tn // 2, 8)
            else:
                tk = max(tk // 2, 8)
        return tm, tk, tn
    if cfg.mem_unit_shape is not None:
        # RSN: units of fixed shape; counts per operand chosen freely (their
        # flexible mapping), but each operand tile is quantized to whole units.
        ur, uc = cfg.mem_unit_shape
        units = cap // (ur * uc)
        # give each operand a share proportional to its footprint, >=1 unit
        fa = m * k
        fb = k * n
        fc = m * n
        tot = fa + fb + fc
        na = max(1, int(units * fa / tot))
        nb = max(1, int(units * fb / tot))
        nc = max(1, units - na - nb)
        # square-ish tiling of units per operand
        tm = min(m, ur * max(1, int(na ** 0.5)))
        tk = min(k, uc * max(1, na // max(1, int(na ** 0.5))))
        tn = min(n, uc * max(1, int(nb ** 0.5)))
        return max(tm, ur), max(tk, uc), max(tn, uc)
    # CHARM-style: fixed buffer shapes
    assert cfg.buf_a and cfg.buf_b
    return cfg.buf_a[0], cfg.buf_a[1], cfg.buf_b[1]


def layer_latency(cfg: AccelConfig, platform: PlatformProfile,
                  m: int, k: int, n: int, *, dtype_bytes: int = 4,
                  num_cus: Optional[int] = None,
                  tile_override: Optional[Tuple[int, int, int]] = None,
                  ) -> LatencyBreakdown:
    """Price one (m x k) @ (k x n) layer on a design point."""
    am, ak, an = platform.atom_shape
    cus = num_cus if num_cus is not None else cfg.num_cus
    flops_valid = 2.0 * m * k * n

    # ---- compute side ----------------------------------------------------
    if cfg.fp:
        # flexible loop bounds: issue only atoms covering the valid region
        atoms = _ceil(m, am) * _ceil(k, ak) * _ceil(n, an)
        tm_c, tk_c, tn_c = (tile_override or
                            _onchip_tiles(cfg, m, k, n, dtype_bytes))
        passes = _ceil(m, tm_c) * _ceil(k, tk_c) * _ceil(n, tn_c)
    else:
        # static instruction block: every pass computes the whole fixed tile
        tile = tile_override or cfg.tile or _onchip_tiles(cfg, m, k, n,
                                                          dtype_bytes)
        tm_c, tk_c, tn_c = tile
        passes = _ceil(m, tm_c) * _ceil(k, tk_c) * _ceil(n, tn_c)
        atoms = passes * (_ceil(tm_c, am) * _ceil(tk_c, ak) * _ceil(tn_c, an))
    flops_issued = atoms * platform.atom_flops
    pipeline = passes * PIPELINE_FILL_ATOMS
    engines = cus * cfg.aies_per_cu
    compute_cycles = (atoms + pipeline) * platform.atom_cycles / max(engines, 1)
    compute_s = compute_cycles / platform.compute_clock_hz

    # ---- DDR side ----------------------------------------------------------
    tm, tk, tn = tile_override or _onchip_tiles(cfg, m, k, n, dtype_bytes)
    if cfg.fmv:
        eff_a = m * k
        eff_b = k * n
        eff_c = m * n
    else:
        # padded transfers: operands quantized to buffer/unit shapes
        if cfg.mem_unit_shape is not None:
            ur, uc = cfg.mem_unit_shape
            eff_a = _ceil(m, ur) * ur * _ceil(k, uc) * uc
            eff_b = _ceil(k, ur) * ur * _ceil(n, uc) * uc
            eff_c = _ceil(m, ur) * ur * _ceil(n, uc) * uc
        else:
            ba = cfg.buf_a or (tm, tk)
            bb = cfg.buf_b or (tk, tn)
            bc = cfg.buf_c or (tm, tn)
            eff_a = _ceil(m, ba[0]) * ba[0] * _ceil(k, ba[1]) * ba[1]
            eff_b = _ceil(k, bb[0]) * bb[0] * _ceil(n, bb[1]) * bb[1]
            eff_c = _ceil(m, bc[0]) * bc[0] * _ceil(n, bc[1]) * bc[1]
    reuse_a = _ceil(n, tn)              # A streamed once per N-tile
    reuse_b = _ceil(m, tm)              # B streamed once per M-tile
    kpasses = _ceil(k, tk)              # C accumulated on-chip across k? only
    c_passes = 1 if tk >= k else 2 * kpasses - 1   # read+write per extra pass
    ddr_bytes = dtype_bytes * (eff_a * reuse_a + eff_b * reuse_b
                               + eff_c * c_passes)
    ddr_s = ddr_bytes / platform.hbm_bw

    # ---- on-chip streams ---------------------------------------------------
    stream_bytes = dtype_bytes * (eff_a * reuse_a + eff_b * reuse_b
                                  + eff_c * c_passes)
    stream_s = stream_bytes / platform.onchip_bw

    launch_s = LAUNCH_OVERHEAD_S * passes / max(cus, 1)
    total = max(compute_s, ddr_s, stream_s) + launch_s
    return LatencyBreakdown(compute_s, ddr_s, stream_s, launch_s, total,
                            flops_valid, flops_issued, ddr_bytes,
                            cfg.num_fmus, cus)


# per-hop latency of one ring all-reduce phase on the serving mesh's ICI.
# What makes the serving DSE's TP-degree choice non-trivial: sharding a step
# over p CUs divides its bandwidth terms by p but adds 2(p-1) latency-bound
# collective phases per layer — for a small/reduced model the phases dominate
# and Stage 1 correctly picks tp < cus.
ICI_HOP_LATENCY_S = 1.0e-6

# per-step host cost of each extra data-parallel engine replica in a grant.
# Replica slices execute concurrently on disjoint CUs, but the fabric
# dispatches their steps from one host thread, so every replica past the
# first adds one serialized launch (same scale as LAUNCH_OVERHEAD_S) — the
# COAC-style switching tax that keeps Stage 1 from tiling a grant into
# replicas the queue cannot fill.
REPLICA_DISPATCH_OVERHEAD_S = 2.0e-6


def dp_dispatch_overhead(replicas: int) -> float:
    """Per-step host serialization cost of running ``replicas`` engine
    replicas of one tenant inside a grant (zero at dp=1)."""
    return max(int(replicas) - 1, 0) * REPLICA_DISPATCH_OVERHEAD_S


def tp_collective_latency(platform: PlatformProfile, degree: int,
                          bytes_per_device: float) -> float:
    """Seconds for one tensor-parallel all-reduce of ``bytes_per_device``
    activation bytes across ``degree`` chips (ring: 2(p-1) phases, each
    moving ~bytes/p over one ICI link plus a fixed hop latency).  Degree
    <= 1 costs nothing; a platform without a profiled ICI bandwidth
    (``ici_bw`` 0, e.g. the Versal board's stream fabric) prices the
    latency phases only."""
    p = max(int(degree), 1)
    if p <= 1:
        return 0.0
    phases = 2 * (p - 1)
    if platform.ici_bw <= 0:
        return phases * ICI_HOP_LATENCY_S
    return phases * (ICI_HOP_LATENCY_S
                     + bytes_per_device / (p * platform.ici_bw))


def decode_kv_read_latency(cfg: AccelConfig, platform: PlatformProfile,
                           batch: int, kv_heads: int, head_dim: int,
                           kv_len: int, *, dtype_bytes: int = 4) -> float:
    """Per-layer HBM seconds one decode step spends streaming a KV cache:
    2·kv_heads·head_dim·kv_len K/V elements per live slot, pure bandwidth
    on the composed sub-accelerator (each CU owns its HBM slice, so the
    read scales down with the grant like every other bandwidth term).

    ``kv_len`` is what the step actually reads: the full per-slot capacity
    on the padded decode path, but only the live prefix under the ragged
    decode kernels (``ServeConfig.use_kernels``) — the traffic difference
    the serving DSE prices through this term.  Also prices the enc-dec
    cross-attention source-cache read (same per-row footprint)."""
    if kv_len <= 0:
        return 0.0
    kv_bytes = (dtype_bytes * max(batch, 1) * float(kv_len)
                * 2.0 * kv_heads * head_dim)
    return kv_bytes / (max(cfg.num_cus, 1) * platform.hbm_bw)


def ssm_step_latency(cfg: AccelConfig, platform: PlatformProfile,
                     batch: int, d_model: int, d_inner: int, state_dim: int,
                     conv_width: int, dt_rank: int, *,
                     dtype_bytes: int = 4) -> float:
    """Price ONE mamba-block decode step on a design point.

    An SSM decode step is not a GEMM pipeline: the projections are batched
    GEMVs against once-streamed weights, and the recurrence is an
    elementwise update of the (batch, d_inner, N) hidden state that must be
    read AND written every token.  The step is therefore bound by *state +
    parameter bandwidth*, with compute far below the MM roofline — the
    class-aware serving policy prices SSM tenants with this model instead of
    the decode-GEMM model, which is exactly where heterogeneous composition
    wins (a bandwidth-starved class and a compute-starved class happily
    split one fabric).
    """
    b = max(batch, 1)
    # weights streamed once per step (in/x/dt/out projections + conv taps)
    param_elems = (2 * d_model * d_inner          # in_proj (x and z)
                   + conv_width * d_inner          # depthwise conv
                   + d_inner * (dt_rank + 2 * state_dim)   # x_proj
                   + dt_rank * d_inner             # dt_proj
                   + d_inner * d_model)            # out_proj
    # recurrent state: h (d_inner, N) and the conv window, read + written
    state_elems = 2 * b * (d_inner * state_dim + (conv_width - 1) * d_inner)
    ddr_s = dtype_bytes * (param_elems + state_elems) \
        / (max(cfg.num_cus, 1) * platform.hbm_bw)
    # compute: one MAC per streamed weight per batch row (GEMVs) plus ~6
    # elementwise ops per state element (exp, mul, add of the recurrence)
    flops = 2.0 * b * param_elems + 6.0 * b * d_inner * state_dim
    engine_flops_s = (platform.atom_flops * platform.compute_clock_hz
                      / platform.atom_cycles)
    compute_s = flops / (max(cfg.num_cus * cfg.aies_per_cu, 1)
                         * engine_flops_s)
    return max(compute_s, ddr_s) + LAUNCH_OVERHEAD_S


# ---------------------------------------------------------------------------
# design points: FILCO + the paper's baselines on VCK190
# ---------------------------------------------------------------------------

ONCHIP_ELEMS = (VCK190.onchip_bytes // 4)          # fp32 elements on chip


def filco_vck190(num_cus: int = 8, num_fmus: int = 16) -> AccelConfig:
    return AccelConfig(
        name="FILCO", num_cus=num_cus, aies_per_cu=48, num_fmus=num_fmus,
        onchip_elems=ONCHIP_ELEMS, fp=True, fmv=True, fmf=True)


def filco_ablation(fp=True, fmf=False, fmv=False) -> AccelConfig:
    """FILCO with feature subsets (Fig. 10 ablation)."""
    tag = "FILCO(" + ",".join(
        s for s, on in (("FP", fp), ("FMF", fmf), ("FMV", fmv)) if on) + ")"
    # without FMF the buffers keep the static monolithic split; with FMF the
    # arena re-splits per layer (transfers quantize to the chosen tiles
    # unless FMV makes them exact)
    static_bufs = None if fmf else (1024, 1024)
    return AccelConfig(
        name=tag, num_cus=8, aies_per_cu=48, num_fmus=16,
        onchip_elems=ONCHIP_ELEMS, fp=fp, fmv=fmv, fmf=fmf,
        buf_a=static_bufs, buf_b=static_bufs, buf_c=static_bufs,
        tile=None if fp else (1024, 1024, 1024))


def charm_monolithic() -> List[AccelConfig]:
    """CHARM-1: one monolithic accelerator, all resources, fixed big tiles."""
    return [AccelConfig(
        name="CHARM-1", num_cus=8, aies_per_cu=48, num_fmus=16,
        onchip_elems=ONCHIP_ELEMS,
        buf_a=(1024, 1024), buf_b=(1024, 1024), buf_c=(1024, 1024),
        tile=(1024, 1024, 1024))]


def charm_two() -> List[AccelConfig]:
    """CHARM-2: a big + a small statically partitioned accelerator."""
    return [
        AccelConfig(name="CHARM-2/big", num_cus=6, aies_per_cu=48,
                    num_fmus=12, onchip_elems=ONCHIP_ELEMS * 3 // 4,
                    buf_a=(768, 768), buf_b=(768, 768), buf_c=(768, 768),
                    tile=(768, 768, 768)),
        AccelConfig(name="CHARM-2/small", num_cus=2, aies_per_cu=48,
                    num_fmus=4, onchip_elems=ONCHIP_ELEMS // 4,
                    buf_a=(256, 256), buf_b=(256, 256), buf_c=(256, 256),
                    tile=(256, 256, 256)),
    ]


def charm_three() -> List[AccelConfig]:
    return [
        AccelConfig(name="CHARM-3/big", num_cus=5, aies_per_cu=48,
                    num_fmus=10, onchip_elems=ONCHIP_ELEMS * 5 // 8,
                    buf_a=(768, 768), buf_b=(768, 768), buf_c=(768, 768),
                    tile=(768, 768, 768)),
        AccelConfig(name="CHARM-3/mid", num_cus=2, aies_per_cu=48,
                    num_fmus=4, onchip_elems=ONCHIP_ELEMS // 4,
                    buf_a=(256, 256), buf_b=(256, 256), buf_c=(256, 256),
                    tile=(256, 256, 256)),
        AccelConfig(name="CHARM-3/small", num_cus=1, aies_per_cu=48,
                    num_fmus=2, onchip_elems=ONCHIP_ELEMS // 8,
                    buf_a=(128, 128), buf_b=(128, 128), buf_c=(128, 128),
                    tile=(128, 128, 128)),
    ]


def rsn_overlay() -> List[AccelConfig]:
    """RSN: flexible operand->memory-unit mapping (FMF-like counts) but a
    static per-unit matrix shape and a fixed computation tile (§1, §5)."""
    return [AccelConfig(
        name="RSN", num_cus=8, aies_per_cu=48, num_fmus=16,
        onchip_elems=ONCHIP_ELEMS, mem_unit_shape=(256, 256),
        tile=(256, 256, 256))]


def best_accel_latency(accels: Sequence[AccelConfig],
                       platform: PlatformProfile,
                       m: int, k: int, n: int) -> LatencyBreakdown:
    """Latency on the best-fitting sub-accelerator of a composition
    (CHARM-2/3 route each layer to its best member)."""
    return min((layer_latency(a, platform, m, k, n) for a in accels),
               key=lambda lb: lb.total_s)
