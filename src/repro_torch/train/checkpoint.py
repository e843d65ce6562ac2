"""Checkpoints of the port (``repro.train.checkpoint``'s format): a
directory per step holding

  manifest.json -- step, the flat tree's leaves (file, shape, dtype), extra
  <leaf-path>.npy -- one array per leaf

over the port's trees (dicts, and lists of per-layer dicts: a list index
is a path key).  bf16 leaves, which numpy lacks, are stored as their
uint16 bits with dtype "bfloat16" in the manifest.  Atomicity: written to
``<dir>.tmp`` and renamed; ``latest_step`` sees complete checkpoints only.
``restore`` copies each leaf IN PLACE into the matching tensor of ``like``
(its device and dtype), so a restore holds no second copy of the state.

DTensor leaves (a mesh) keep the format: ``save``, called by every rank,
gathers each leaf whole (one leaf at a time) and rank 0 writes it;
``restore`` reads the whole array on every rank and copies the local shard
of ``like``'s placements, on whatever mesh ``like`` lives on.  So a
checkpoint saved on one mesh restores onto another mesh shape, other
placements, or one device (the elastic reshard).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distribution.partitioning import distribute, is_dtensor

PyTree = Any

_SEP = "/"


def _flatten_with_paths(tree: PyTree, path=()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten_with_paths(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, path + (str(i),))]
    return [(_SEP.join(path), tree)]


def save(ckpt_dir: str, step: int, tree: PyTree,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a checkpoint atomically.  Returns the final directory.  With
    DTensor leaves every rank calls it; rank 0 writes."""
    flat = _flatten_with_paths(tree)
    sharded = any(is_dtensor(leaf) for _, leaf in flat)
    writer = not sharded or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in flat:
        t = leaf.full_tensor() if is_dtensor(leaf) else torch.as_tensor(leaf)
        t = t.detach()
        if not writer:
            continue
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.cpu().numpy()
        fname = name.replace(_SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if sharded:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: PyTree
            ) -> Tuple[PyTree, Dict[str, Any]]:
    """Copy the checkpoint's leaves into ``like`` (a tree of tensors or
    DTensors of the saved structure) in place; returns (like, extra)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten_with_paths(like)
    missing = [n for n, _ in flat if n not in manifest["leaves"]]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
    with torch.no_grad():
        for name, t in flat:
            meta = manifest["leaves"][name]
            if list(t.shape) != meta["shape"]:
                raise ValueError(f"{name}: checkpoint shape {meta['shape']} "
                                 f"!= {list(t.shape)}")
            src = torch.from_numpy(np.load(os.path.join(final,
                                                        meta["file"])))
            if meta["dtype"] == "bfloat16":
                src = src.view(torch.bfloat16)
            if is_dtensor(t):
                src = distribute(src.to(t.to_local().device), t.device_mesh,
                                 t.placements).to_local()
                t = t.to_local()
            t.copy_(src)
    return like, manifest["extra"]
