"""Platform profiles — the hardware constants the analytical model is
parameterized by.

FILCO's framework takes "platform information and DDR profiling results" as
input (paper §3.1, Fig. 6).  We keep that contract: every latency estimate in
``repro_torch.core.analytical`` reads from a :class:`PlatformProfile`, never
from hard-coded constants.

One profile ships: ``VCK190``, the paper's evaluation board (AMD Versal
ACAP, 150 MHz PL, 1 GHz AIE), which the paper path's DSE prices designs on.
An H100 profile comes with the port's fabric slice.
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

PROFILES = {p.name: p for p in (VCK190,)}


def get_profile(name: str) -> PlatformProfile:
    return PROFILES[name]
