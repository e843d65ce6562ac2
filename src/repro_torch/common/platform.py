"""Platform profiles — the hardware constants the analytical model is
parameterized by.

FILCO's framework takes "platform information and DDR profiling results" as
input (paper §3.1, Fig. 6).  We keep that contract: every latency estimate in
``repro_torch.core.analytical`` reads from a :class:`PlatformProfile`, never
from hard-coded constants.

Two profiles ship:

* ``VCK190`` — the paper's evaluation board (AMD Versal ACAP, 150 MHz PL,
  1 GHz AIE), which the paper path's DSE prices designs on;
* ``H100_SXM`` — one NVIDIA H100 SXM (data sheet figures), which the
  serving fabric prices tenants on.

The serving fabric composes one card out of ``N`` logical CUs, and its
policy prices a tenant on ``c`` CUs as ``c/N`` of the card's compute,
bandwidth and memory: :func:`per_cu` is that share as a profile (the
reference's profiles are per chip, and a chip is one of its CUs).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PlatformProfile:
    name: str
    # -- compute ---------------------------------------------------------
    peak_flops: float          # peak FLOP/s per chip (fp32 for AIE)
    atom_shape: tuple          # (m, k, n) of the atomic matmul the ISA issues
    atom_cycles: float         # pipelined cycles per atomic matmul
    compute_clock_hz: float    # clock of the compute array
    num_compute_units: int     # AIEs per device / MXU passes available
    # -- memory ----------------------------------------------------------
    hbm_bytes: int             # off-chip (DDR / HBM) capacity per chip
    hbm_bw: float              # off-chip bandwidth, bytes/s per chip
    onchip_bytes: int          # on-chip SRAM (PL URAM+BRAM) per chip
    onchip_bw: float           # on-chip stream bandwidth, bytes/s
    # -- interconnect ----------------------------------------------------
    ici_bw: float              # per-link inter-chip bandwidth, bytes/s (0 = N/A)
    ici_links: int             # links per chip participating in a collective
    # -- control ---------------------------------------------------------
    instr_bytes: int           # bytes per instruction word
    reconfig_cycles: float     # cycles to decode+apply one runtime instruction
    bitstream_reload_s: float  # full reconfiguration cost (bitstream / recompile)

    @property
    def atom_flops(self) -> float:
        m, k, n = self.atom_shape
        return 2.0 * m * k * n

    def matmul_atoms(self, m: int, k: int, n: int) -> int:
        """Number of atomic ops for an (m,k,n) matmul, ceil-padded per axis."""
        am, ak, an = self.atom_shape
        ceil = lambda x, a: -(-x // a)
        return ceil(m, am) * ceil(k, ak) * ceil(n, an)


def _ceil(x: int, a: int) -> int:
    return -(-x // a)


# ---------------------------------------------------------------------------
# AMD Versal VCK190 (paper's board).  AIE: 400 tiles @ 1 GHz, fp32 MM intrinsics
# issue one 2x8x8 MAC-block per cycle when fully pipelined (paper §2.2 packs a
# 2x8x8 tiled MM as the atomic operation).  PL at 150 MHz moves data between
# FMUs (URAM/BRAM) and the AIE array over AXI streams (paper §4: 150 MHz PL,
# 1 GHz AIE).  DDR4 bandwidth on the board is ~25.6 GB/s.
# ---------------------------------------------------------------------------
VCK190 = PlatformProfile(
    name="vck190",
    peak_flops=400 * (2 * 8 * 8 * 2) * 1.0e9,   # 400 AIEs x 256 FLOP/atom x 1 GHz
    atom_shape=(2, 8, 8),
    atom_cycles=1.0,
    compute_clock_hz=1.0e9,
    num_compute_units=400,
    hbm_bytes=8 << 30,
    hbm_bw=25.6e9,
    onchip_bytes=(130 << 20) // 8,               # ~16 MB URAM+BRAM usable
    onchip_bw=150e6 * 128 * 4,                   # 150 MHz x 128 B ports x 4 chans
    ici_bw=0.0,
    ici_links=0,
    instr_bytes=32,
    reconfig_cycles=8.0,                         # decode a few bytes of instr
    bitstream_reload_s=1.0,                      # full PDI reload ~seconds
)

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM (data sheet, dense rates): 132 SMs; bf16 on the tensor
# cores at 989 TFLOP/s = 132 SMs x 4096 FLOP/clock at 1.83 GHz, counted in
# wgmma m64n256k16 atoms (524288 FLOP, 128 clocks each); 80 GB of HBM3 at
# 3.35 TB/s; 228 KB of shared memory per SM at 128 B/clock.  One card has no
# inter-chip link in this model.  ``bitstream_reload_s`` is the port's own
# measured cost of one decode-graph capture on the card, 0.13-0.18 s
# (PERF.md §2): what a recomposition that is not warmed pays.
# ---------------------------------------------------------------------------
H100_SXM = PlatformProfile(
    name="h100_sxm",
    peak_flops=989e12,
    atom_shape=(64, 16, 256),
    atom_cycles=128.0,
    compute_clock_hz=1.83e9,
    num_compute_units=132,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    onchip_bytes=132 * 228 * 1024,
    onchip_bw=132 * 128 * 1.83e9,
    ici_bw=0.0,
    ici_links=0,
    instr_bytes=32,
    reconfig_cycles=16.0,
    bitstream_reload_s=0.15,
)

# The serving fabric's default CU count on one card: 8, as the reference's
# 8-column fabric, so decisions on both can be compared.
DEFAULT_CUS = 8


def per_cu(profile: PlatformProfile, num_cus: int) -> PlatformProfile:
    """One CU's share of ``profile`` when the card is composed of
    ``num_cus`` logical CUs: compute, bandwidth and memory divided by
    ``num_cus`` (``num_compute_units`` may come out fractional: 16.5 SMs a
    CU at 132 / 8).  The analytical model then prices ``c`` CUs as ``c``
    times this share, as it prices ``c`` chips of the reference's mesh."""
    n = max(int(num_cus), 1)
    return dataclasses.replace(
        profile, name=f"{profile.name}/{n}",
        peak_flops=profile.peak_flops / n,
        num_compute_units=profile.num_compute_units / n,
        hbm_bytes=profile.hbm_bytes // n,
        hbm_bw=profile.hbm_bw / n,
        onchip_bytes=profile.onchip_bytes // n,
        onchip_bw=profile.onchip_bw / n)


PROFILES = {p.name: p for p in (VCK190, H100_SXM)}


def get_profile(name: str) -> PlatformProfile:
    return PROFILES[name]
