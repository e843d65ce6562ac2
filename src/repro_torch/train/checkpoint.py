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
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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
    """Write a checkpoint atomically.  Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in _flatten_with_paths(tree):
        t = torch.as_tensor(leaf).detach()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.cpu().numpy()
        fname = name.replace(_SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
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
    """Copy the checkpoint's leaves into ``like`` (a tree of tensors of the
    saved structure) in place; returns (like, extra)."""
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
            t.copy_(src)
    return like, manifest["extra"]
