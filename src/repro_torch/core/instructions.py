"""FILCO instruction set (paper §2.5, Table 1).

Each function unit in the data plane decodes its own instruction stream; an
instruction is a few bytes — decoding one *is* the runtime reconfiguration
(no bitstream reload / recompile).  We keep the exact field lists of Table 1
and add binary encode/decode (fixed-width little-endian words) so streams can
be written to files, diffed, and replayed by the functional simulator.

Function units:
  InstrGen  — loads the stream header, dispatches to destination units
  IOMLoad   — DDR -> FMU transfer (submatrix window of an (M, N) operand)
  IOMStore  — FMU -> DDR transfer
  FMUInstr  — ping/pong op, src/des CU routing, 1-D-addressed window
  CUInstr   — compute op: consume operand streams from FMUs, emit result
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterable, List, Sequence, Tuple, Union

# unit ids for des_unit routing
UNIT_IOM_LOAD = 0
UNIT_IOM_STORE = 1
UNIT_FMU = 2
UNIT_CU = 3

# FMU/CU micro-ops
OP_NOP = 0
OP_RECV_IOM = 1      # FMU: receive `count` elements from IO manager
OP_SEND_CU = 2       # FMU: send the (row/col) window to des_cu
OP_RECV_CU = 3       # FMU: receive result elements from src_cu
OP_MM = 1            # CU: flexible matmul (loop bounds from count/rows/cols)


@dataclasses.dataclass(frozen=True)
class InstrGen:
    is_last: bool
    des_unit: int         # which function unit this block targets
    valid_length: int     # number of valid instructions in the block

    _FMT = "<BBH"

    def encode(self) -> bytes:
        return struct.pack(self._FMT, self.is_last, self.des_unit,
                           self.valid_length)

    @classmethod
    def decode(cls, b: bytes) -> "InstrGen":
        a, d, v = struct.unpack(cls._FMT, b)
        return cls(bool(a), d, v)


@dataclasses.dataclass(frozen=True)
class IOMLoad:
    is_last: bool
    ddr_addr: int
    des_fmu: int
    m: int                # full operand rows in DDR
    n: int                # full operand cols in DDR
    start_row: int
    end_row: int
    start_col: int
    end_col: int

    _FMT = "<BQHIIIIII"

    def encode(self) -> bytes:
        return struct.pack(self._FMT, self.is_last, self.ddr_addr,
                           self.des_fmu, self.m, self.n, self.start_row,
                           self.end_row, self.start_col, self.end_col)

    @classmethod
    def decode(cls, b: bytes) -> "IOMLoad":
        f = struct.unpack(cls._FMT, b)
        return cls(bool(f[0]), *f[1:])


@dataclasses.dataclass(frozen=True)
class IOMStore:
    is_last: bool
    ddr_addr: int
    src_fmu: int
    m: int
    n: int
    start_row: int
    end_row: int
    start_col: int
    end_col: int

    _FMT = "<BQHIIIIII"

    def encode(self) -> bytes:
        return struct.pack(self._FMT, self.is_last, self.ddr_addr,
                           self.src_fmu, self.m, self.n, self.start_row,
                           self.end_row, self.start_col, self.end_col)

    @classmethod
    def decode(cls, b: bytes) -> "IOMStore":
        f = struct.unpack(cls._FMT, b)
        return cls(bool(f[0]), *f[1:])


@dataclasses.dataclass(frozen=True)
class FMUInstr:
    is_last: bool
    ping_op: int          # op for the ping buffer this cycle
    pong_op: int          # op for the pong buffer this cycle
    src_cu: int
    des_cu: int
    count: int            # elements to receive (OP_RECV_*)
    start_row: int        # 1-D-addressed 2-D window (OP_SEND_CU) — the
    end_row: int          #   flexible memory *view* (paper §2.3)
    start_col: int
    end_col: int
    view_cols: int = 0    # row stride of the current view (FMV runtime shape)

    _FMT = "<BBBHHIIIIII"

    def encode(self) -> bytes:
        return struct.pack(self._FMT, self.is_last, self.ping_op,
                           self.pong_op, self.src_cu, self.des_cu, self.count,
                           self.start_row, self.end_row, self.start_col,
                           self.end_col, self.view_cols)

    @classmethod
    def decode(cls, b: bytes) -> "FMUInstr":
        f = struct.unpack(cls._FMT, b)
        return cls(bool(f[0]), *f[1:])


@dataclasses.dataclass(frozen=True)
class CUInstr:
    is_last: bool
    ping_op: int
    pong_op: int
    src_fmu: int          # operand-A FMU
    des_fmu: int          # result FMU
    count: int            # packed runtime loop bounds (m,k,n atoms) — the
                          #   flexible-parallelism instruction (paper §2.2)
    src_fmu_b: int = 0    # operand-B FMU (FILCO routes both operands)

    _FMT = "<BBBHHIH"

    def encode(self) -> bytes:
        return struct.pack(self._FMT, self.is_last, self.ping_op,
                           self.pong_op, self.src_fmu, self.des_fmu,
                           self.count, self.src_fmu_b)

    @classmethod
    def decode(cls, b: bytes) -> "CUInstr":
        f = struct.unpack(cls._FMT, b)
        return cls(bool(f[0]), *f[1:])


Instr = Union[InstrGen, IOMLoad, IOMStore, FMUInstr, CUInstr]

_DECODERS = {
    "gen": InstrGen, "iom_load": IOMLoad, "iom_store": IOMStore,
    "fmu": FMUInstr, "cu": CUInstr,
}


def pack_mkn(m_atoms: int, k_atoms: int, n_atoms: int) -> int:
    """Pack runtime loop bounds into the CU `count` field (10 bits each)."""
    assert 0 <= m_atoms < 1024 and 0 <= k_atoms < 1024 and 0 <= n_atoms < 1024
    return (m_atoms << 20) | (k_atoms << 10) | n_atoms


def unpack_mkn(count: int) -> Tuple[int, int, int]:
    return (count >> 20) & 1023, (count >> 10) & 1023, count & 1023


def encode_stream(instrs: Sequence[Instr]) -> bytes:
    """Encode a homogeneous instruction stream (one function unit)."""
    return b"".join(i.encode() for i in instrs)


def decode_stream(kind: str, data: bytes) -> List[Instr]:
    cls = _DECODERS[kind]
    size = struct.calcsize(cls._FMT)
    assert len(data) % size == 0, (kind, len(data), size)
    out = []
    for off in range(0, len(data), size):
        out.append(cls.decode(data[off: off + size]))
    return out


def stream_bytes(instrs: Iterable[Instr]) -> int:
    return sum(len(i.encode()) for i in instrs)
