"""The port's side of ``tests/test_torch_distributed.py``: a gloo world of 8
CPU ranks (``torch.multiprocessing.spawn``, one thread each, a ``file://``
rendezvous of its own) that runs every distributed scenario on the port
and pickles what rank 0 gathers.

    python tests/_torch_dist_worker.py REF_PICKLE OUT_PICKLE

REF_PICKLE is the reference run's output (the initial parameters and the
batches it trained on, the compressed-psum inputs); this file imports no
JAX.
"""
import dataclasses
import datetime
import os
import pickle
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
WORLD = 8


def _gather(tree):
    from repro_torch.optim import tree_map

    def full(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.detach().float().numpy()

    return tree_map(full, tree)


def _shard(params, model, mesh, rules):
    """A full parameter tree (alike on every rank) -> its DTensors laid
    out by the model's logical specs under ``rules``."""
    from repro_torch.distribution import partitioning as part

    return part.tree_map_specs(
        lambda s, t: part.distribute(t, mesh, rules.shard(mesh, s, t.shape)),
        model.logical_specs(), params)


def _sharded_steps(ref, mesh, out):
    """Two steps of qwen2.5-reduced on (2, 4) from the reference's initial
    parameters and batches, per dtype and sequence parallelism, and the
    port's single-device steps (rank 0).  Returns the fp32 state saved by
    the elastic scenario."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_reduced
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.optim import make_optimizer
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           make_train_step)

    tc = TrainConfig(steps=4, lr=1e-3, warmup=1)
    state = None
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), dtype=dt)
        model = Model(cfg, "cpu")
        opt = make_optimizer(cfg.optimizer)
        full = lambda: params_from_jax(ref["params0"], cfg, "cpu",
                                       dtype=torch.float32)
        for sp in (False, True):
            rules = part.train_rules(sequence_parallel=sp)
            params = _shard(full(), model, mesh, rules)
            opt_state = opt.init(params)
            tr = Trainer(model, tc, mesh, rules, device="cpu")
            losses = []
            for s, b in enumerate(ref["batches"]):
                params, opt_state, m = tr._step(params, opt_state, s,
                                                tr._to_device(b))
                losses.append(float(m["loss"]))
            out[(dt, sp)] = (losses, _gather(params))
            if dt == "float32" and not sp:
                state = {"params": params, "opt": opt_state}
        if dist.get_rank() == 0:
            params = full()
            opt_state = opt.init(params)
            step = make_train_step(model, opt, tc)
            losses = []
            for s, b in enumerate(ref["batches"]):
                params, opt_state, m = step(
                    params, opt_state, s,
                    {k: torch.as_tensor(v) for k, v in b.items()})
                losses.append(float(m["loss"]))
            out[(dt, "single")] = (losses, _gather(params))
    return state


def _fit(mesh, out):
    """Trainer.fit on the mesh from setup_sharded_state (the port's seeded
    init), each rank's pipeline giving its batch rows, against
    Trainer.fit on one device (rank 0)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import make_pipeline
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import TrainConfig, Trainer, batch_shard

    cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), dtype="float32")
    model = Model(cfg, "cpu")
    ckpt = tempfile.mkdtemp()
    tc = TrainConfig(steps=3, lr=1e-3, warmup=1, checkpoint_every=0,
                     log_every=1, ckpt_dir=ckpt)
    tr = Trainer(model, tc, mesh, device="cpu")
    host_id, num_hosts = batch_shard(mesh, tr.rules)
    tr.pipeline = make_pipeline(cfg, 16, 4, host_id=host_id,
                                num_hosts=num_hosts)
    res = tr.fit()
    out["fit_mesh"] = ([m["loss"] for m in res["metrics"]],
                       _gather(res["params"]), (host_id, num_hosts))
    if dist.get_rank() == 0:
        one = Trainer(model, tc, pipeline=make_pipeline(cfg, 16, 4),
                      device="cpu").fit()
        out["fit_single"] = ([m["loss"] for m in one["metrics"]],
                             _gather(one["params"]))


def _elastic(ref, mesh, state, out):
    """Save on (2, 4); restore onto (4, 2) with transposed placements, and
    onto one device (rank 0)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_reduced
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.optim import make_optimizer, tree_leaves, tree_map
    from repro_torch.train import checkpoint as ck

    mesh_b = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box)
    tree = {"w": part.distribute(w, mesh, [Shard(0), Shard(1)]),
            "state": state}
    ck.save(box[0], 1, tree, extra={"mesh": [2, 4]})
    full = _gather(state)
    cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), dtype="float32")
    zeros = tree_map(torch.zeros_like, params_from_jax(
        ref["params0"], cfg, "cpu", dtype=torch.float32))
    like_p = _shard(zeros, Model(cfg, "cpu"), mesh_b,
                    part.train_rules(sequence_parallel=False))
    like = {"w": part.distribute(torch.zeros(8, 8), mesh_b,
                                 [Shard(1), Shard(0)]),
            "state": {"params": like_p,
                      "opt": make_optimizer("adamw").init(like_p)}}
    got, extra = ck.restore(box[0], 1, like)
    out["elastic_mesh"] = {
        "w_equal": bool(torch.equal(got["w"].full_tensor(), w)),
        "w_local": tuple(got["w"].to_local().shape),
        "saved_mesh": extra["mesh"],
        "state_equal": all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(_gather(got["state"])), tree_leaves(full)))}
    if dist.get_rank() == 0:
        like1 = {"w": torch.zeros(8, 8),
                 "state": tree_map(lambda a: torch.zeros(a.shape), full)}
        got1, _ = ck.restore(box[0], 1, like1)
        out["elastic_single"] = bool(torch.equal(got1["w"], w)) and all(
            np.array_equal(a.numpy(), b) for a, b in
            zip(tree_leaves(got1["state"]), tree_leaves(full)))


def _compression(ref, out):
    """compressed_psum and two rounds of ErrorFeedback over an 8-wide pod
    mesh, each rank's row of the reference's inputs."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.optim import ErrorFeedback, compressed_psum, tree_map

    rank = dist.get_rank()
    group = init_device_mesh("cpu", (WORLD,),
                             mesh_dim_names=("pod",)).get_group("pod")
    y = compressed_psum(torch.from_numpy(ref["psum_x"][rank]), group)
    ys = [None] * WORLD
    dist.all_gather_object(ys, y.numpy())
    out["psum"] = np.stack(ys)
    g = {k: torch.from_numpy(v[rank]) for k, v in ref["ef_g"].items()}
    e = ErrorFeedback.init(g)
    rounds = []
    for it in range(2):
        a, e = ErrorFeedback.apply(tree_map(lambda t: t * (1 + it), g), e,
                                   group)
        pair = (tree_map(lambda t: t.numpy(), a),
                tree_map(lambda t: t.float().numpy(), e))
        every = [None] * WORLD
        dist.all_gather_object(every, pair)
        rounds.append(every)
    out["ef"] = rounds


_HEAD_CASES = [(4, 2), (8, 2), (8, 4), (16, 2), (8, 1), (6, 2)]


def _local_heads(out):
    """``attention._attend`` on DTensors (batch on data, heads on model,
    KV heads replicated) against the unsharded call: output and the
    gradients of q, k and v, for query and KV head counts whose groups a
    rank holds part of, exactly, several of, and (6 on a 4-wide model dim)
    none evenly."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distribution import partitioning as part
    from repro_torch.models import attention as A

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    errs = {}
    for hq, hkv in _HEAD_CASES:
        gen = torch.Generator().manual_seed(hq * 10 + hkv)
        q, k, v = (torch.randn(4, 12, h, 8, generator=gen)
                   for h in (hq, hkv, hkv))
        dy = torch.randn(4, 12, hq, 8, generator=gen)
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        y = A._attend(*ts, use_kernels=True, causal=True)
        (y * dy).sum().backward()
        place = [Shard(0), Replicate()]
        ds = [part.distribute(t, mesh, place).requires_grad_(True)
              for t in (q, k, v)]
        with implicit_replication():
            yd = A._attend(*ds, use_kernels=True, causal=True)
            (yd * part.distribute(dy, mesh, place)).sum().backward()
        pairs = [(yd, y)] + [(d.grad, t.grad) for d, t in zip(ds, ts)]
        errs[(hq, hkv)] = max(float((a.full_tensor() - b).abs().max())
                              for a, b in pairs)
    out["local_heads"] = errs


def _run(rank, init, ref_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = {}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    state = _sharded_steps(ref, mesh, out)
    _fit(mesh, out)
    _elastic(ref, mesh, state, out)
    _compression(ref, out)
    _local_heads(out)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    rendezvous = "file://" + os.path.join(tempfile.mkdtemp(), "rdzv")
    mp.spawn(_run, args=(rendezvous, sys.argv[1], sys.argv[2]),
             nprocs=WORLD)
