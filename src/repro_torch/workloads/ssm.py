"""SSM (Mamba) serving engine of the port (``repro.workloads.ssm``):
recurrent decode from a constant-size state slot pool.

A Mamba tenant carries O(1) state per slot, a conv window plus the
(d_inner, N) recurrent state per layer, so admission is slot-bound, never
length-bound: any prompt length and any generation budget occupy exactly
one state slot (``mamba_prefill`` folds the whole prompt into the state).
The continuous-batching machinery (slots, pipelined dispatch from the
executable cache of CUDA graphs, paged admission, preemption with exact
resume, live resizing, evacuation and adoption) is the decode engine's;
this class swaps the admission accounting for the constant-size state
pool.  The base engine prefills SSM archs at the exact prompt length
(one prefill entry per length) and its decode bounds are ``()``: one
decode graph per slot count, each layer's Mamba step in it.  On a mesh
with ``serve_engine_rules()`` each rank holds its slice of the d_in
channels of the params and of the state pool (conv window and state);
admission still counts the whole model's state per slot, so every degree
admits the same requests.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models import ssm as S
from repro_torch.models.model import Model
from repro_torch.obs import Telemetry
from repro_torch.workloads.base import SSM
from repro_torch.workloads.compile_cache import ExecutableCache
from repro_torch.workloads.decode import DecodeEngine, Request, ServeConfig


class SSMEngine(DecodeEngine):
    workload_class = SSM

    def __init__(self, model: Model, params, cfg: ServeConfig,
                 exec_cache: Optional[ExecutableCache] = None,
                 obs: Optional[Telemetry] = None, mesh=None, rules=None):
        mc = model.cfg
        if mc.ssm is None or not mc.attention_free:
            raise ValueError(
                f"SSMEngine serves attention-free SSM archs; {mc.name!r} is "
                f"family={mc.family!r} (use DecodeEngine for archs with a "
                "KV cache)")
        super().__init__(model, params, cfg, exec_cache=exec_cache, obs=obs,
                         mesh=mesh, rules=rules)

    # ------------------------------------------------------------------
    # constant-size state pool: admission accounting hooks
    # ------------------------------------------------------------------
    def _per_token_cache_elems(self) -> int:
        """Per-SLOT (not per-token) recurrent-state elements over all
        layers; ``_slot_rows`` is 1, so arena views are (1, state)."""
        return S.state_elems(self.model.cfg) * self.model.cfg.num_layers

    def _arena_capacity(self) -> int:
        # one state slot per decode slot: max_len plays no part
        return self.cfg.max_slots * self._per_token_elems

    def _slot_rows(self, req: Request) -> int:
        return 1

    def _row_cap(self) -> int:
        # one arena row per slot: pages never grow, preemption still
        # exports the state block like any slot
        return 1

    def _oversized(self, req: Request) -> bool:
        # no prompt length or generation budget can overflow a state slot
        return False
