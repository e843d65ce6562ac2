"""Host-side core of the port.

  arena        — FlexArena/PagedArena admission arenas of the serving paths
  analytical   — latency model over accelerator design points (FILCO,
                 CHARM-1/2/3, RSN) on the VCK190 profile
  modes        — Stage-1 Runtime Parameter Optimizer (brute force)
  schedule     — scheduling problem + validator (Eq. 1-6 semantics)
  milp         — explicit MILP formulation + exact branch-and-bound solver
  ga           — the paper's GA heuristic (Encode/Candidate chromosome)
  dse          — two-stage DSE driver -> ExecutionPlan
  instructions — the Table-1 ISA with binary encode/decode
  codegen      — ExecutionPlan -> per-unit instruction streams
  simulator    — data-plane simulator on torch tensors, each CU pass
                 through the ``flex_mm`` kernel on a CUDA device

All but ``simulator`` are framework-free copies of the reference's modules.
"""
