"""Host-side core of the port.

  arena        — FlexArena/PagedArena admission arenas of the serving paths,
                 and the view ops on a flat torch buffer
  analytical   — latency model over accelerator design points (FILCO,
                 CHARM-1/2/3, RSN) on a platform profile
  modes        — Stage-1 Runtime Parameter Optimizer (brute force)
  schedule     — scheduling problem + validator (Eq. 1-6 semantics)
  milp         — explicit MILP formulation + exact branch-and-bound solver
  ga           — the paper's GA heuristic (Encode/Candidate chromosome)
  dse          — two-stage DSE driver -> ExecutionPlan
  composer     — CU composer: a CU is a logical share of one card; delta
                 recomposition planning
  instructions — the Table-1 ISA with binary encode/decode
  codegen      — ExecutionPlan -> per-unit instruction streams
  simulator    — data-plane simulator on torch tensors, each CU pass
                 through the ``flex_mm`` kernel on a CUDA device
  gpu_modes    — assigned-arch layers lowered to MM DAGs and the two-stage
                 DSE on an H100 composed of CUs (``repro.core.tpu_modes``)

All but ``simulator`` and the arena's view ops are framework-free copies of
the reference's modules.
"""
