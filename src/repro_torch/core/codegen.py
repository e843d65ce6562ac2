"""Code generator: ExecutionPlan -> per-function-unit instruction streams
(paper Fig. 6 "Code Generator / Instruction Generator" and §2.5/Table 1).

DDR layout convention (the "ready-to-run binary" addressing):
  * every layer's weight operand (B matrix) gets a static DDR region;
  * every layer's result (C) gets a DDR region, which downstream layers load
    as their activation operand (A);
  * layer 0's activation input is the workload input region.

Per scheduled layer the emitted program is:
  IOMLoad  A -> fmu_ids[0]          FMU(A): RECV_IOM, then SEND_CU window
  IOMLoad  B -> fmu_ids[1]          FMU(B): RECV_IOM, then SEND_CU window
  CU(each cu_id): OP_MM with packed runtime (m,k,n) atom bounds — the
      flexible-parallelism instruction; rows are split across the CUs
  FMU(C = fmu_ids[2]): RECV_CU, then IOMStore C -> DDR

The functional simulator (repro_torch.core.simulator) executes these streams
against numpy DDR/arena state and must reproduce the workload's reference
numerics — the end-to-end test of ISA + arena + kernel semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.common.platform import PlatformProfile, VCK190
from repro_torch.configs.paper_workloads import MMWorkload
from repro_torch.core import instructions as isa
from repro_torch.core.dse import ExecutionPlan, PlannedLayer


@dataclasses.dataclass(frozen=True)
class DDRLayout:
    """Element offsets of every operand region in DDR."""

    input_addr: int
    weight_addr: Dict[int, int]       # layer -> B-matrix region
    result_addr: Dict[int, int]       # layer -> C-matrix region
    total_elems: int


def plan_ddr_layout(workload: MMWorkload) -> DDRLayout:
    cursor = 0
    first = workload.layers[0]
    input_addr = cursor
    cursor += first.m * first.k
    weight_addr, result_addr = {}, {}
    for i, l in enumerate(workload.layers):
        weight_addr[i] = cursor
        cursor += l.k * l.n
    for i, l in enumerate(workload.layers):
        result_addr[i] = cursor
        cursor += l.m * l.n
    return DDRLayout(input_addr, weight_addr, result_addr, cursor)


@dataclasses.dataclass(frozen=True)
class CUWork:
    """One CU pass: (cu_id, compute instr, A-send, B-send, C-recv)."""

    cu_id: int
    compute: isa.CUInstr
    send_a: isa.FMUInstr
    send_b: isa.FMUInstr
    recv_c: isa.FMUInstr


@dataclasses.dataclass(frozen=True)
class LayerProgram:
    """The micro-program of one scheduled layer, in dataflow order."""

    layer: int
    loads: Tuple[isa.IOMLoad, ...]
    recv_iom: Tuple[Tuple[int, isa.FMUInstr], ...]   # (fmu_id, instr)
    cu_work: Tuple[CUWork, ...]
    fmu_c: int
    store: isa.IOMStore


@dataclasses.dataclass
class Program:
    """Instruction streams per function unit (+ generator header blocks) and
    the layer-ordered micro-programs the simulator replays."""

    gen: List[isa.InstrGen]
    iom_load: List[isa.IOMLoad]
    iom_store: List[isa.IOMStore]
    fmu: Dict[int, List[isa.FMUInstr]]
    cu: Dict[int, List[isa.CUInstr]]
    layout: DDRLayout
    layer_programs: List[LayerProgram] = dataclasses.field(default_factory=list)

    def total_bytes(self) -> int:
        n = isa.stream_bytes(self.gen) + isa.stream_bytes(self.iom_load) \
            + isa.stream_bytes(self.iom_store)
        for s in self.fmu.values():
            n += isa.stream_bytes(s)
        for s in self.cu.values():
            n += isa.stream_bytes(s)
        return n


def _a_source(workload: MMWorkload, layout: DDRLayout, li: int) -> int:
    """Activation operand region: the first dependency whose result shape
    matches this layer's (m, k) A operand; otherwise the workload input
    region (layers fed through reshapes/pools — PointNet's T-Net applies —
    consume an external tensor; the dependency still gates scheduling)."""
    layer = workload.layers[li]
    for d in layer.deps:
        dep = workload.layers[d]
        if (dep.m, dep.n) == (layer.m, layer.k):
            return layout.result_addr[d]
    return layout.input_addr


def generate(workload: MMWorkload, plan: ExecutionPlan,
             platform: PlatformProfile = VCK190) -> Program:
    layout = plan_ddr_layout(workload)
    am, ak, an = platform.atom_shape
    prog = Program(gen=[], iom_load=[], iom_store=[], fmu={}, cu={},
                   layout=layout)

    def fmu_stream(u: int) -> List[isa.FMUInstr]:
        return prog.fmu.setdefault(u, [])

    def cu_stream(u: int) -> List[isa.CUInstr]:
        return prog.cu.setdefault(u, [])

    ordered = sorted(plan.layers, key=lambda p: (p.start, p.layer))
    for pl in ordered:
        li = pl.layer
        m, k, n = pl.mkn
        assert len(pl.fmu_ids) >= 3, "layer needs A/B/C FMU views"
        fa, fb, fc = pl.fmu_ids[0], pl.fmu_ids[1], pl.fmu_ids[2]

        # --- IOM loads ---------------------------------------------------
        load_a = isa.IOMLoad(
            is_last=False, ddr_addr=_a_source(workload, layout, li),
            des_fmu=fa, m=m, n=k, start_row=0, end_row=m,
            start_col=0, end_col=k)
        load_b = isa.IOMLoad(
            is_last=False, ddr_addr=layout.weight_addr[li],
            des_fmu=fb, m=k, n=n, start_row=0, end_row=k,
            start_col=0, end_col=n)
        prog.iom_load += [load_a, load_b]

        # --- FMU receive + send views (FMV: 1-D windows) ------------------
        recv_a = isa.FMUInstr(
            is_last=False, ping_op=isa.OP_RECV_IOM, pong_op=isa.OP_NOP,
            src_cu=0, des_cu=pl.cu_ids[0], count=m * k,
            start_row=0, end_row=m, start_col=0, end_col=k, view_cols=k)
        recv_b = isa.FMUInstr(
            is_last=False, ping_op=isa.OP_RECV_IOM, pong_op=isa.OP_NOP,
            src_cu=0, des_cu=pl.cu_ids[0], count=k * n,
            start_row=0, end_row=k, start_col=0, end_col=n, view_cols=n)
        fmu_stream(fa).append(recv_a)
        fmu_stream(fb).append(recv_b)

        # --- CU compute: rows split across the allocated CUs --------------
        ncu = len(pl.cu_ids)
        rows_per = -(-m // ncu)
        work: List[CUWork] = []
        for ci, cu_id in enumerate(pl.cu_ids):
            r0 = ci * rows_per
            r1 = min(m, r0 + rows_per)
            if r0 >= r1:
                continue
            send_a = isa.FMUInstr(
                is_last=False, ping_op=isa.OP_SEND_CU, pong_op=isa.OP_NOP,
                src_cu=0, des_cu=cu_id, count=(r1 - r0) * k,
                start_row=r0, end_row=r1, start_col=0, end_col=k,
                view_cols=k)
            send_b = isa.FMUInstr(
                is_last=False, ping_op=isa.OP_SEND_CU, pong_op=isa.OP_NOP,
                src_cu=0, des_cu=cu_id, count=k * n,
                start_row=0, end_row=k, start_col=0, end_col=n,
                view_cols=n)
            compute = isa.CUInstr(
                is_last=False, ping_op=isa.OP_MM, pong_op=isa.OP_NOP,
                src_fmu=fa, des_fmu=fc,
                count=isa.pack_mkn(-(-(r1 - r0) // am), -(-k // ak),
                                   -(-n // an)),
                src_fmu_b=fb)
            recv_c = isa.FMUInstr(
                is_last=False, ping_op=isa.OP_RECV_CU, pong_op=isa.OP_NOP,
                src_cu=cu_id, des_cu=0, count=(r1 - r0) * n,
                start_row=r0, end_row=r1, start_col=0, end_col=n,
                view_cols=n)
            fmu_stream(fa).append(send_a)
            fmu_stream(fb).append(send_b)
            cu_stream(cu_id).append(compute)
            fmu_stream(fc).append(recv_c)
            work.append(CUWork(cu_id, compute, send_a, send_b, recv_c))

        # --- result store --------------------------------------------------
        store_c = isa.IOMStore(
            is_last=False, ddr_addr=layout.result_addr[li], src_fmu=fc,
            m=m, n=n, start_row=0, end_row=m, start_col=0, end_col=n)
        prog.iom_store.append(store_c)
        prog.layer_programs.append(LayerProgram(
            layer=li, loads=(load_a, load_b),
            recv_iom=((fa, recv_a), (fb, recv_b)), cu_work=tuple(work),
            fmu_c=fc, store=store_c))

    # mark stream tails + generator headers
    def _finalize(stream):
        if stream:
            stream[-1] = dataclasses.replace(stream[-1], is_last=True)

    _finalize(prog.iom_load)
    _finalize(prog.iom_store)
    for s in prog.fmu.values():
        _finalize(s)
    for s in prog.cu.values():
        _finalize(s)
    prog.gen.append(isa.InstrGen(False, isa.UNIT_IOM_LOAD,
                                 len(prog.iom_load)))
    prog.gen.append(isa.InstrGen(False, isa.UNIT_IOM_STORE,
                                 len(prog.iom_store)))
    for u, s in sorted(prog.fmu.items()):
        prog.gen.append(isa.InstrGen(False, isa.UNIT_FMU, len(s)))
    for u, s in sorted(prog.cu.items()):
        prog.gen.append(isa.InstrGen(False, isa.UNIT_CU, len(s)))
    _finalize(prog.gen)
    return prog
