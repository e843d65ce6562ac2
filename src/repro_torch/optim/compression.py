"""Gradient compression for cross-pod data parallelism (the port of
``repro.optim.compression``).

Across pods gradient volume dominates, so the trainer can reduce the pod
dim explicitly with int8-quantized summands (one per-tensor scale,
symmetric, no stochastic rounding) and error feedback, cutting cross-pod
bytes 4x against fp32.  ``compressed_psum`` is the wire primitive over a
process group (a mesh dim's: ``mesh.get_group("pod")``); ``ErrorFeedback``
keeps the quantization residual so that the compression is unbiased over
time.  The arithmetic is the reference's, in fp32 and in its order, and
rounds half to even as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.base import tree_leaves, tree_map

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _reduce(x32: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """(q, scale, mean of the decoded summands over ``group``): one
    all-reduce (MAX) of amax for the global scale, int8 quantization, an
    int32 all-reduce (SUM), then ``* scale / n``."""
    amax = x32.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    return q, scale, qsum.float() * scale / n


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean-reduce ``x`` over ``group`` with an int8 payload.

    The ranks first agree on a GLOBAL scale (int8 values quantized under
    different scales cannot be summed), then quantize and sum in int32
    (exact).  The only loss is the shared scale's rounding, at most scale/2
    per element (absorbed by error feedback at the caller)."""
    return _reduce(x.float(), group)[2].to(x.dtype)


class ErrorFeedback:
    """Residual-carrying compression: compress(g + e), e' = input -
    decoded, the residual kept in bf16."""

    @staticmethod
    def init(params: PyTree) -> PyTree:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                              device=p.device), params)

    @staticmethod
    def apply(grads: PyTree, residual: PyTree, group=None
              ) -> Tuple[PyTree, PyTree]:
        def one(g, e):
            x = g.float() + e.float()
            q, scale, mean = _reduce(x, group)
            new_e = (x - dequantize_int8(q, scale)).to(torch.bfloat16)
            return mean.to(g.dtype), new_e

        both = [one(g, e) for g, e in zip(tree_leaves(grads),
                                          tree_leaves(residual))]
        gs, es = iter([b[0] for b in both]), iter([b[1] for b in both])
        return (tree_map(lambda _: next(gs), grads),
                tree_map(lambda _: next(es), residual))
