"""Assigned-architecture configs -> FILCO MM workloads -> the two-stage DSE
on one H100 (the port's counterpart of ``repro.core.tpu_modes``, which
prices the same DAGs on the reference's TPU chip).

A transformer layer of any assigned arch is the kind of diverse MM DAG
FILCO schedules.  :func:`arch_workload` lowers one layer (or a block stack)
to an :class:`MMWorkload`; :func:`dse_for_arch` runs the two-stage DSE on
the card composed of CUs (:func:`h100_accel`), yielding per-layer tile
choices and a composed schedule as the paper does on the VCK190.

What a CU is here: an SM share of the card, as the serving fabric's CU
(``common.platform.per_cu``).  The analytical model prices compute as CUs
x ``aies_per_cu`` engines of one ``atom_shape`` atom per ``atom_cycles``;
``H100_SXM``'s atom is a wgmma m64n256k16 at 4096 FLOP per SM clock, so
the engines of a CU are its SMs: ``132 // num_cus`` (16 of 8 CUs, so the
composed card prices at 128 of the 132 SMs' peak).  The FMU capacity is
those SMs' shared memory (``smem_frac`` of it, the rest left to the
kernels' own staging), viewed as ``2 * num_cus`` FMUs as the paper's board
has 16 FMUs for 8 CUs.  Host-side and framework-free, like ``dse``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.common.platform import H100_SXM, PlatformProfile
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.configs.paper_workloads import MMLayer, MMWorkload
from repro_torch.core.analytical import AccelConfig
from repro_torch.core.dse import DSEResult, run_dse
from repro_torch.core.ga import GAConfig


def h100_accel(num_cus: int = 8, smem_frac: float = 0.75) -> AccelConfig:
    """One H100 as a FILCO design point: ``num_cus`` CUs of
    ``132 // num_cus`` SMs each, FMUs = views of their shared memory."""
    sms = H100_SXM.num_compute_units // num_cus
    smem_per_sm = H100_SXM.onchip_bytes // H100_SXM.num_compute_units
    elems = int(num_cus * sms * smem_per_sm * smem_frac) // 4
    return AccelConfig(
        name="FILCO-H100", num_cus=num_cus, aies_per_cu=sms,
        num_fmus=2 * num_cus, onchip_elems=elems, fp=True, fmv=True,
        fmf=True)


def arch_workload(cfg: ModelConfig, cell: ShapeCell, *, layers: int = 1,
                  tokens_per_device: Optional[int] = None) -> MMWorkload:
    """Lower `layers` transformer layers of an arch to an MM DAG.

    Shapes are per-device: tokens_per_device defaults to the cell's global
    tokens / 256 chips (the reference's single-pod mesh), so the DAG is
    the reference's.
    """
    d, hq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    if tokens_per_device is None:
        if cell.kind == "decode":
            tokens_per_device = max(cell.global_batch // 256, 1)
        else:
            tokens_per_device = max(cell.global_batch * cell.seq_len // 256, 8)
    t = tokens_per_device
    nodes: List[MMLayer] = []
    prev: Tuple[int, ...] = ()
    for li in range(layers):
        base = len(nodes)
        if cfg.mla is not None:
            m = cfg.mla
            nodes.append(MMLayer(f"l{li}.q", t, d,
                                 hq * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                                 prev))
            nodes.append(MMLayer(f"l{li}.dkv", t, d,
                                 m.kv_lora_rank + m.qk_rope_head_dim, prev))
            nodes.append(MMLayer(f"l{li}.ukv", t, m.kv_lora_rank,
                                 hq * (m.qk_nope_head_dim + m.v_head_dim),
                                 (base + 1,)))
            o_dep = (base + 2,)
        elif cfg.attention_free:
            o_dep = prev
        else:
            nodes.append(MMLayer(f"l{li}.qkv", t, d, (hq + 2 * hkv) * hd, prev))
            kv = min(cell.seq_len, 4096)    # per-device attended kv window
            nodes.append(MMLayer(f"l{li}.qk", hq * t, hd, kv, (base,)))
            nodes.append(MMLayer(f"l{li}.av", hq * t, kv, hd, (base + 1,)))
            nodes.append(MMLayer(f"l{li}.o", t, hq * hd, d, (base + 2,)))
            o_dep = (base + 3,)
        if cfg.ssm is not None:
            d_in = cfg.ssm.d_inner or cfg.ssm.expand * d
            nodes.append(MMLayer(f"l{li}.ssm_in", t, d, 2 * d_in, prev))
            nodes.append(MMLayer(f"l{li}.ssm_out", t, d_in, d,
                                 (len(nodes) - 1,)))
            o_dep = (len(nodes) - 1,)
        # FFN / MoE (routed experts appear as per-expert token slabs)
        if cfg.moe is not None:
            mo = cfg.moe
            per_e = max(t * mo.top_k // mo.num_experts, 1)
            # a representative subset of expert MMs keeps the DAG tractable
            for e in range(min(mo.num_experts, 8)):
                nodes.append(MMLayer(f"l{li}.e{e}.up", per_e, d,
                                     mo.expert_d_ff, o_dep))
                nodes.append(MMLayer(f"l{li}.e{e}.down", per_e,
                                     mo.expert_d_ff, d, (len(nodes) - 1,)))
            if mo.dense_residual:
                nodes.append(MMLayer(f"l{li}.dense_up", t, d,
                                     mo.dense_residual_d_ff or cfg.d_ff, o_dep))
                nodes.append(MMLayer(f"l{li}.dense_down", t,
                                     mo.dense_residual_d_ff or cfg.d_ff, d,
                                     (len(nodes) - 1,)))
            prev = (len(nodes) - 1,)
        elif cfg.d_ff:
            nodes.append(MMLayer(f"l{li}.ffn_up", t, d, cfg.d_ff, o_dep))
            nodes.append(MMLayer(f"l{li}.ffn_down", t, cfg.d_ff, d,
                                 (len(nodes) - 1,)))
            prev = (len(nodes) - 1,)
        else:
            prev = o_dep
    return MMWorkload(f"{cfg.name}/{cell.name}/L{layers}", tuple(nodes))


def dse_for_arch(cfg: ModelConfig, cell: ShapeCell, *,
                 platform: PlatformProfile = H100_SXM,
                 accel: Optional[AccelConfig] = None,
                 seed: int = 0) -> DSEResult:
    """The two-stage DSE of one layer of ``cfg`` at ``cell`` on ``accel``
    (``h100_accel()`` by default) priced on ``platform``, with the
    reference's solver settings."""
    wl = arch_workload(cfg, cell)
    return run_dse(wl, accel if accel is not None else h100_accel(),
                   platform, solver="ga", max_modes=5,
                   ga_config=GAConfig(population=16, generations=20,
                                      seed=seed, patience=8))
