"""Functional data-plane simulator on torch tensors: executes FILCO
instruction streams against DDR and FMU-arena state held on a device
(paper Fig. 2's data plane in software).

Port of the reference's ``core/simulator.py``.  Running the generated
program for a workload must reproduce the workload's reference numerics
(layer-chain matmuls).  DDR and the FMUs live on ``device``; on a CUDA
device every CU pass (``OP_MM``) goes through the hand-written ``flex_mm``
kernel, on the CPU through its plain version.  When a program is run, the
valid ``(m, k, n)`` of all its CU passes are written to the device once,
as a ``[P, 3]`` int32 table (the CU instruction memory); pass ``p`` hands
the kernel row ``p``.  FMU windows go to the kernel as strided views and
the kernel writes its result straight into the receiving FMU, so nothing
is copied per pass and host and device never sync between instructions:
the only sync is whoever reads the results back.

Instruction streams are executed in program order per unit with a simple
dataflow handshake (FMU send -> CU consume -> FMU receive), which is
sufficient for numerics; timing is the analytical model's job.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import instructions as isa
from repro_torch.core.codegen import Program
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.filco_mm import ops as fm


@dataclasses.dataclass
class FMUState:
    """1-D addressed double buffer (we model the ping buffer; pong is used
    for overlap, which does not change numerics)."""

    data: torch.Tensor                     # flat fp32 elements
    view_cols: int = 0                     # current runtime view stride


def cu_pass_dims(prog: Program) -> Tuple[Tuple[int, int, int], ...]:
    """The valid (m, k, n) of every CU pass, in replay order: the rows and
    columns of the A window and the columns of the B window."""
    return tuple(
        (w.send_a.end_row - w.send_a.start_row,
         w.send_a.end_col - w.send_a.start_col,
         w.send_b.end_col - w.send_b.start_col)
        for lp in prog.layer_programs for w in lp.cu_work)


class DataPlaneSim:
    def __init__(self, ddr_elems: int, num_fmus: int, fmu_capacity: int,
                 num_cus: int, *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.ddr = torch.zeros(ddr_elems, dtype=torch.float32,
                               device=self.device)
        self.fmus = {u: FMUState(torch.zeros(
            fmu_capacity, dtype=torch.float32, device=self.device))
            for u in range(num_fmus)}
        self.num_cus = num_cus

    # -- IOM ---------------------------------------------------------------
    def _iom_load(self, ins: isa.IOMLoad) -> None:
        rows = ins.end_row - ins.start_row
        cols = ins.end_col - ins.start_col
        full = self.ddr[ins.ddr_addr: ins.ddr_addr + ins.m * ins.n]
        mat = full.view(ins.m, ins.n)[ins.start_row:ins.end_row,
                                      ins.start_col:ins.end_col]
        fmu = self.fmus[ins.des_fmu]
        fmu.data[: rows * cols].view(rows, cols).copy_(mat)
        fmu.view_cols = cols

    def _iom_store(self, ins: isa.IOMStore) -> None:
        rows = ins.end_row - ins.start_row
        cols = ins.end_col - ins.start_col
        mat = self.fmus[ins.src_fmu].data[: rows * cols].view(rows, cols)
        full = self.ddr[ins.ddr_addr: ins.ddr_addr + ins.m * ins.n]
        full.view(ins.m, ins.n)[ins.start_row:ins.end_row,
                                ins.start_col:ins.end_col].copy_(mat)

    # -- FMU ----------------------------------------------------------------
    def _fmu_window(self, fmu_id: int, ins: isa.FMUInstr) -> torch.Tensor:
        """The 1-D addressed window of a send: rows [start_row, end_row) x
        cols [start_col, end_col) of the runtime (.., cols) view (FMV), as
        one strided view."""
        fmu = self.fmus[fmu_id]
        cols = fmu.view_cols or (ins.end_col - ins.start_col)
        r = ins.end_row - ins.start_row
        c = ins.end_col - ins.start_col
        start = ins.start_row * cols + ins.start_col
        return fmu.data.as_strided((r, c), (cols, 1), start)

    def _fmu_recv_cu(self, fmu_id: int, ins: isa.FMUInstr) -> torch.Tensor:
        """Where a CU's (r, c) result lands: contiguous at start_row * cols
        + start_col of the receiving FMU, which takes the (.., cols) view."""
        fmu = self.fmus[fmu_id]
        cols = ins.end_col - ins.start_col
        r = ins.end_row - ins.start_row
        start = ins.start_row * cols + ins.start_col
        fmu.view_cols = cols
        return fmu.data[start: start + r * cols].view(r, cols)

    # -- program execution ------------------------------------------------
    def run(self, prog: Program) -> None:
        """Replay the layer-ordered micro-programs.  Dataflow order within a
        layer: IOM loads -> per-CU (send A, send B, compute, recv C) -> IOM
        store.  Layers execute in schedule order; concurrency does not
        change numerics (disjoint units by Eq. 4), so sequential replay is
        the semantic reference."""
        assert prog.layer_programs, "program has no layer micro-programs"
        # the CU instruction memory: every pass's (m, k, n), written once
        imem = torch.tensor(cu_pass_dims(prog), dtype=torch.int32).reshape(
            -1, 3).to(self.device)
        p = 0
        for lp in prog.layer_programs:
            for ins in lp.loads:
                self._iom_load(ins)
            for w in lp.cu_work:
                fa, fb = w.compute.src_fmu, w.compute.src_fmu_b
                # the kernel writes FMU C while it reads FMU A and B
                assert lp.fmu_c not in (fa, fb), (lp.layer, fa, fb, lp.fmu_c)
                a = self._fmu_window(fa, w.send_a)
                b = self._fmu_window(fb, w.send_b)
                assert a.shape[1] == b.shape[0], (a.shape, b.shape)
                out = self._fmu_recv_cu(lp.fmu_c, w.recv_c)
                fm.flex_mm(a, b, imem[p], out=out)
                p += 1
            self._iom_store(lp.store)
