"""Dense FFN and Mixture-of-Experts FFN of the port (``repro.models.moe``):
top-k routing with capacity, shared experts, the dense-residual branch
(Arctic); DeepSeek's first-k-dense layers are the transformer's prologue.

Dispatch is the reference's GShard einsum formulation (one-hot dispatch
and combine tensors, every expert run on its capacity rows) or its
gather variant (``dispatch_impl="gather"``: source-token indices built by
a scatter, then gathers).  Tokens dispatch per group: a batch row, or
``group_size`` tokens when a row is a whole multiple of it, with capacity
C = int(T * top_k / E * capacity_factor) per expert and group, assigned
slot by slot (all first choices, then all second ones), drops included.

Nothing here waits on the host (no ``nonzero``, boolean indexing,
``F.one_hot``'s range check or ``.item()``): one-hots compare against an
``arange``, so a decode step through an MoE layer captures as a CUDA
graph.

Under autograd (training) the gradient reaches the router through the
normalised gate values in ``combine`` (or the gather path's weights) and
through the aux loss's mean probabilities; the capacity positions, the
keep mask and ``dispatch = (combine > 0)`` are integer or boolean and
carry none, as under ``jax.grad`` of the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distribution import partitioning as part
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# dense FFN (also the non-MoE path) and the stacked experts
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int, *, dtype,
             device, expert_dim: int = 0) -> Params:
    """Plain (or GLU) MLP weights, fan-in scaled as in the reference; with
    ``expert_dim`` > 0, stacked over a leading expert axis."""
    d = cfg.d_model
    lead = (expert_dim,) if expert_dim else ()

    def w(shape):
        return torch.randn(lead + shape, generator=gen, dtype=dtype,
                           device=device) * (1.0 / math.sqrt(shape[0]))

    p = {"w_up": w((d, d_ff)), "w_down": w((d_ff, d))}
    if cfg.glu:
        p["w_gate"] = w((d, d_ff))
    return p


def ffn_specs(cfg: ModelConfig, *, expert: bool = False
              ) -> Dict[str, tuple]:
    """Logical specs of ``ffn_init``'s leaves; expert weights take their
    own axes ("expert", "expert_embed", "expert_mlp") so that rules can
    shard experts and their inner dim apart from the dense FFN's."""
    lead = ("expert",) if expert else ()
    ax_d = "expert_embed" if expert else "embed"
    ax_f = "expert_mlp" if expert else "mlp"
    p = {"w_up": lead + (ax_d, ax_f), "w_down": lead + (ax_f, ax_d)}
    if cfg.glu:
        p["w_gate"] = lead + (ax_d, ax_f)
    return p


def ffn_apply(p: Params, cfg: ModelConfig, x):
    """Weights cast to x's dtype at use, as in ``attention._proj``."""
    act = L.activation(cfg.act)
    up = part.rows_matmul(x, p["w_up"].to(x.dtype))
    if cfg.glu:
        h = act(part.rows_matmul(x, p["w_gate"].to(x.dtype))) * up
    else:
        h = act(up)
    return part.rows_matmul(h, p["w_down"].to(x.dtype))


def ffn_split(p: Params, width: int, tp) -> bool:
    """True when a dense FFN of hidden ``width`` holds a rank's slice of
    its hidden dim on a tensor-parallel mesh (``tp``, a
    ``partitioning.TPShard``): its output is then a partial sum."""
    return tp is not None and p["w_down"].shape[0] < width


def reduce_ffn(y, p: Params, width: int, tp):
    """``ffn_apply``'s output ``y``, summed over the model group in place
    where its hidden dim is split (row-parallel ``w_down``)."""
    if ffn_split(p, width, tp):
        tp.all_reduce(y)
    return y


def _expert_ffn(p: Params, cfg: ModelConfig, x):
    """x: (E, rows, d), batched over the stacked weights' expert axis;
    weights cast to x's dtype at use, as in ``ffn_apply``."""
    act = L.activation(cfg.act)
    up = torch.bmm(x, p["w_up"].to(x.dtype))
    if cfg.glu:
        h = act(torch.bmm(x, p["w_gate"].to(x.dtype))) * up
    else:
        h = act(up)
    return torch.bmm(h, p["w_down"].to(x.dtype))


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
             device) -> Dict[str, object]:
    mo = cfg.moe
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, object] = {
        "router": torch.randn((cfg.d_model, mo.num_experts), generator=gen,
                              **kw) * 0.02,
        "experts": ffn_init(gen, cfg, mo.expert_d_ff,
                            expert_dim=mo.num_experts, **kw),
    }
    if mo.num_shared_experts:
        p["shared"] = ffn_init(
            gen, cfg,
            mo.num_shared_experts * (mo.shared_d_ff or mo.expert_d_ff), **kw)
    if mo.dense_residual:
        p["dense"] = ffn_init(gen, cfg, mo.dense_residual_d_ff or cfg.d_ff,
                              **kw)
    return p


def moe_specs(cfg: ModelConfig) -> Dict[str, object]:
    """Logical specs of ``moe_init``'s leaves."""
    mo = cfg.moe
    p: Dict[str, object] = {"router": ("embed", None),
                            "experts": ffn_specs(cfg, expert=True)}
    if mo.num_shared_experts:
        p["shared"] = ffn_specs(cfg)
    if mo.dense_residual:
        p["dense"] = ffn_specs(cfg)
    return p


def capacity(mo: MoEConfig, group_tokens: int) -> int:
    c = int(group_tokens * mo.top_k / mo.num_experts * mo.capacity_factor)
    return max(c, 1)


def _one_hot(idx, n: int, dtype):
    """``idx`` (...) -> (..., n), zero rows where idx lies outside [0, n)
    (as ``jax.nn.one_hot``), with no check that syncs with the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _routing(p, mo: MoEConfig, xg):
    """xg: (G, T, d) -> gates (G, T, k), idx (G, T, k), probs (G, T, E),
    all fp32 but idx.  Router logits accumulate in fp32 from operands in
    the activation dtype, as the reference's preferred_element_type."""
    logits = xg.float() @ p["router"].to(xg.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, mo.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return gate_vals, idx, probs


def _capacity_positions(idx, E: int, C: int):
    """Slot-by-slot capacity assignment (GShard): (pos, keep), pos (G, T,
    k) int32 position in its expert, keep (G, T, k) bool (pos < C)."""
    G, T, K = idx.shape
    counts = torch.zeros((G, E), dtype=torch.int32, device=idx.device)
    poss, keeps = [], []
    for j in range(K):
        oh = _one_hot(idx[:, :, j], E, torch.int32)               # (G,T,E)
        pos_e = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh \
            + counts[:, None, :]
        pos = (pos_e * oh).sum(dim=-1, dtype=torch.int32)          # (G,T)
        keep = pos < C
        counts = counts + (oh * keep[..., None]).sum(dim=1,
                                                     dtype=torch.int32)
        poss.append(pos)
        keeps.append(keep)
    return torch.stack(poss, -1), torch.stack(keeps, -1)


def _shared_width(mo: MoEConfig) -> int:
    return mo.num_shared_experts * (mo.shared_d_ff or mo.expert_d_ff)


def moe_apply(p, cfg: ModelConfig, x, *, dispatch_impl: str = "einsum",
              tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  ``tp`` (a ``partitioning.TPShard``,
    serving): the routed experts are this rank's slice of the expert axis
    where the degree divides it, and the shared and dense-residual FFNs
    this rank's slice of their hidden dims where it divides those.  The
    router is whole, so every rank computes the same gates, positions and
    drops; the dispatch and combine run on the rank's experts, and the
    partial outputs are summed over the model group once (the whole ones
    added after)."""
    mo = cfg.moe
    x = part.unshard(x, 1)      # on a mesh: routing and dispatch see S whole
    B0, S0, d = x.shape
    # GShard groups bound the (G, T, E, C) dispatch tensors, C being
    # proportional to the group's tokens
    g = mo.group_size
    if g and S0 > g and S0 % g == 0:
        x = x.reshape(B0 * (S0 // g), g, d)
    B, S, _ = x.shape
    E = mo.num_experts
    C = capacity(mo, S)
    gate_vals, idx, probs = _routing(p, mo, x)
    pos, keep = _capacity_positions(idx, E, C)
    dt = x.dtype
    # this rank's experts [e0, e0 + El): all of them unless split
    El = p["experts"]["w_up"].shape[0]
    e0 = tp.index * El if (tp is not None and El < E) else 0

    if dispatch_impl == "einsum":
        # combine (G, T, E, C): the gate weight at each kept (expert,
        # position), in the activation dtype
        combine = torch.zeros((B, S, E, C), dtype=dt, device=x.device)
        for j in range(mo.top_k):
            oh_e = _one_hot(idx[:, :, j], E, dt)
            oh_c = _one_hot(pos[:, :, j], C, dt)
            w = (gate_vals[:, :, j] * keep[:, :, j]).to(dt)
            combine = combine + w[..., None, None] * \
                (oh_e[..., :, None] * oh_c[..., None, :])
        if El < E:
            combine = combine[:, :, e0:e0 + El]
        dispatch = (combine > 0).to(dt)
        expert_in = torch.einsum("gtec,gtd->gecd", dispatch, x)
        eo = _expert_ffn(p["experts"], cfg,
                         expert_in.transpose(0, 1).reshape(El, B * C, d))
        expert_out = eo.reshape(El, B, C, d).transpose(0, 1)  # (G, E, C, d)
        y = torch.einsum("gtec,gecd->gtd", combine, expert_out)
    elif dispatch_impl == "gather":
        # (G, E, C) source-token index by a scatter; a dropped token goes to
        # a spare capacity column C, sliced off after
        src = torch.zeros((B, E * (C + 1)), dtype=torch.int64,
                          device=x.device)
        has = torch.zeros((B, E * (C + 1)), dtype=dt, device=x.device)
        tok = torch.arange(S, device=x.device).expand(B, S)
        for j in range(mo.top_k):
            p_safe = torch.where(keep[:, :, j], pos[:, :, j], C)
            flat = idx[:, :, j] * (C + 1) + p_safe
            src.scatter_(1, flat, tok)
            has.scatter_(1, flat, torch.ones((B, S), dtype=dt,
                                             device=x.device))
        src = src.reshape(B, E, C + 1)[:, e0:e0 + El, :C]
        has = has.reshape(B, E, C + 1)[:, e0:e0 + El, :C]
        rows = torch.arange(B, device=x.device)[:, None, None]
        expert_in = x[rows, src.clamp(0, S - 1)] * has[..., None]
        eo = _expert_ffn(p["experts"], cfg,
                         expert_in.transpose(0, 1).reshape(El, B * C, d))
        expert_out = eo.reshape(El, B, C, d).transpose(0, 1)
        flat_out = expert_out.reshape(B, El * C, d)
        y = torch.zeros_like(x)
        brow = torch.arange(B, device=x.device)[:, None]
        for j in range(mo.top_k):
            e = idx[:, :, j] - e0
            mine = keep[:, :, j]
            if El < E:
                mine = mine & (e >= 0) & (e < El)
            w = (gate_vals[:, :, j] * mine).to(dt)
            t_out = flat_out[brow, e.clamp(0, El - 1) * C
                             + pos[:, :, j].clamp(0, C - 1)]
            y = y + w[..., None] * t_out
    else:
        raise ValueError(dispatch_impl)

    # auxiliary load-balance loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    fe = _one_hot(idx[:, :, 0], E, torch.float32).mean(dim=(0, 1))
    aux = E * (fe * me).sum()

    # the routed experts', then the shared and dense-residual FFNs'
    # outputs, each with whether it is a partial sum over the model group:
    # the partial ones are summed and all-reduced once, the whole ones
    # added after
    terms = [(y, El < E)]
    if mo.num_shared_experts:
        terms.append((ffn_apply(p["shared"], cfg, x),
                       ffn_split(p["shared"], _shared_width(mo), tp)))
    if mo.dense_residual:
        terms.append((ffn_apply(p["dense"], cfg, x),
                      ffn_split(p["dense"], mo.dense_residual_d_ff or cfg.d_ff,
                                tp)))
    partial = [t for t, split in terms if split]
    if partial:
        y = partial[0]
        for t in partial[1:]:
            y = y + t
        y = tp.all_reduce(y.contiguous())
        whole = [t for t, split in terms if not split]
    else:
        whole = [t for t, _ in terms[1:]]
    for t in whole:
        y = y + t
    return y.reshape(B0, S0, d), aux
