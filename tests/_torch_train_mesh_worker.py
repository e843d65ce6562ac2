"""The port's side of ``tests/test_torch_train_mesh_ssm.py`` and
``tests/test_torch_train_mesh_families.py``: a gloo world of 8 CPU ranks
(``torch.multiprocessing.spawn``, one thread each, a ``file://``
rendezvous of its own) that runs the sharded train step of each arch the
mode names on a (2 data, 4 model) mesh, and the port's single-device step
beside it, and pickles what rank 0 gathers.

    python tests/_torch_train_mesh_worker.py MODE INIT_PICKLE OUT_PICKLE

MODE is ``ssm`` or ``families``; INIT_PICKLE is the reference run's first
output (``tests/_torch_train_mesh_ref.py``: initial parameters, optimizer
and batches per arch).  ``ssm`` adds ``Trainer.fit`` on the mesh for
falcon-mamba-reduced and the scan's local-channel path
(``partitioning.channel_local``); ``families`` adds Adafactor's state on
the mesh and its elastic reshard.  This file imports no JAX.
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
from _torch_dist_worker import _gather, _shard  # noqa: E402
from _torch_train_mesh_runs import flat  # noqa: E402

WORLD = 8
RUNS = {"ssm": (("float32", False), ("float32", True), ("bfloat16", True)),
        "families": (("float32", False), ("float32", True))}


def _place(placements) -> list:
    """DTensor placements as plain values: a dim for Shard, None for
    Replicate."""
    return [p.dim if p.is_shard() else None for p in placements]


def _config(arch, optimizer, dtype):
    from repro_torch.configs import get_reduced

    return dataclasses.replace(get_reduced(arch), dtype=dtype,
                               optimizer=optimizer)


def _steps(init, mesh, out, mode):
    """Each arch's two steps on the mesh per (dtype, sequence
    parallelism), from the reference's initial parameters and batches,
    and the port's single-device steps per dtype (rank 0); the optimizer
    state after the fp32 steps without sequence parallelism, both ways."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.optim import make_optimizer
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           make_train_step)

    tc = TrainConfig(steps=4, lr=1e-3, warmup=1)
    for arch, case in init.items():
        batches = case["batches"]
        for dt in sorted({dt for dt, _ in RUNS[mode]}):
            cfg = _config(arch, case["optimizer"], dt)
            model = Model(cfg, "cpu")
            opt = make_optimizer(cfg.optimizer)
            full = lambda: params_from_jax(case["params0"], cfg, "cpu",
                                           dtype=torch.float32)
            for sp in [sp for d, sp in RUNS[mode] if d == dt]:
                rules = part.train_rules(sequence_parallel=sp)
                params = _shard(full(), model, mesh, rules)
                opt_state = opt.init(params)
                tr = Trainer(model, tc, mesh, rules, device="cpu")
                losses = []
                for s, b in enumerate(batches):
                    params, opt_state, m = tr._step(params, opt_state, s,
                                                    tr._to_device(b))
                    losses.append(float(m["loss"]))
                out[(arch, dt, sp)] = (losses, _gather(params))
                if dt == "float32" and not sp:
                    out[(arch, "opt")] = _gather(opt_state)
            if dist.get_rank() == 0:
                params = full()
                opt_state = opt.init(params)
                step = make_train_step(model, opt, tc)
                losses = []
                for s, b in enumerate(batches):
                    params, opt_state, m = step(
                        params, opt_state, s,
                        {k: torch.as_tensor(v) for k, v in b.items()})
                    losses.append(float(m["loss"]))
                out[(arch, dt, "single")] = (losses, _gather(params))
                if dt == "float32":
                    out[(arch, "opt", "single")] = _gather(opt_state)


def _fit(mesh, out):
    """Trainer.fit on the mesh for falcon-mamba-reduced from
    setup_sharded_state (the port's seeded init), each rank's pipeline
    giving its batch rows, against Trainer.fit on one device (rank 0)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import make_pipeline
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import TrainConfig, Trainer, batch_shard

    cfg = dataclasses.replace(get_reduced("falcon-mamba-7b"),
                              dtype="float32")
    model = Model(cfg, "cpu")
    tc = TrainConfig(steps=3, lr=1e-3, warmup=1, checkpoint_every=0,
                     log_every=1, ckpt_dir=tempfile.mkdtemp())
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


def _scan_local(out):
    """The scan's plain pair through ``partitioning.channel_local`` on a
    (2, 4) and a (1, 8) mesh (each rank its rows and channels), against
    the whole call: y and every gradient, and the layouts the helper
    gives.  Also: a DTensor reaching ``SelectiveScanFn`` raises."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate

    from repro_torch.distribution import partitioning as part
    from repro_torch.kernels.mamba_scan.ops import SelectiveScanFn

    gen = torch.Generator().manual_seed(5)
    B, S, D, N = 4, 40, 32, 8
    x, b, c, gy = (torch.randn(shape, generator=gen) for shape in
                   ((B, S, D), (B, S, N), (B, S, N), (B, S, D)))
    dt = torch.rand((B, S, D), generator=gen) * 0.2
    a_log = torch.log(torch.arange(1, N + 1.0)).expand(D, N).contiguous() \
        + 0.1 * torch.randn((D, N), generator=gen)
    d = torch.randn((D,), generator=gen)
    whole = [t.clone().requires_grad_(True) for t in (x, dt, b, c, a_log, d)]
    y = SelectiveScanFn.apply(*whole, True)
    (y * gy).sum().backward()
    res = {}
    for shape in ((2, 4), (1, 8)):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        rep = [Replicate()] * 2
        ds = [part.distribute(t, mesh, rep).requires_grad_(True)
              for t in (x, dt, b, c, a_log, d)]
        seen = {}

        def fn(*ts):
            seen["shapes"] = [tuple(t.shape) for t in ts]
            return SelectiveScanFn.apply(*ts, True)

        yd = part.channel_local(fn, ds[:2], ds[2:4], ds[4:])
        (yd * part.distribute(gy, mesh, rep)).sum().backward()
        res[shape] = {
            "y": (yd.full_tensor() - y).abs().max().item(),
            "y_place": _place(yd.placements),
            "local_shapes": seen["shapes"],
            # each gradient's largest difference over its largest value
            "grads": [((g.grad.full_tensor() - w.grad).abs().max()
                       / w.grad.abs().max()).item()
                      for g, w in zip(ds, whole)]}
    try:
        SelectiveScanFn.apply(*ds, True)
        res["raises"] = None
    except TypeError as e:
        res["raises"] = str(e)
    out["scan_local"] = res


def _adafactor(init, mesh, out):
    """Adafactor on the mesh: its state's placements, one update at lr 1
    on drawn gradients against the single-device update, and the elastic
    reshard of its state from (2, 4) onto (4, 2) and onto one device."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.bridge import params_from_jax
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.optim import adafactor, tree_map
    from repro_torch.optim.base import leaf_groups
    from repro_torch.train import checkpoint as ck

    arch = "qwen1.5-110b"
    cfg = _config(arch, "adafactor", "float32")
    model = Model(cfg, "cpu")
    rules = part.train_rules()
    full = lambda: params_from_jax(init[arch]["params0"], cfg, "cpu",
                                   dtype=torch.float32)
    opt = adafactor()
    params = _shard(full(), model, mesh, rules)
    state = opt.init(params)
    out["ada_placements"] = {
        name: (_place(ts[0].placements), {
            k: (_place(v.placements), tuple(v.shape))
            for k, v in state["v"][name].items()})
        for name, ts, _ in leaf_groups(params)}
    gen = torch.Generator().manual_seed(7)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen),
                     full())
    before = full()
    opt.update(_shard(grads, model, mesh, rules), state, params, 1.0)
    if dist.get_rank() == 0:
        one = full()
        one_state = opt.init(one)
        opt.update(grads, one_state, one, 1.0)
    moved = flat(_gather(params))
    if dist.get_rank() == 0:
        before, one = flat(before), flat(one)
        # the largest difference of the updates over the largest update
        out["ada_update"] = max(
            float(np.abs(moved[k] - one[k]).max()) for k in one) / max(
            float(np.abs(one[k] - before[k]).max()) for k in one)
        got = flat(_gather(state))
        out["ada_state"] = max(float(np.abs(got[k] - v).max())
                               for k, v in flat(one_state).items())
    else:
        _gather(state)
    # the elastic reshard of the whole state: (2, 4) -> (4, 2), one device
    mesh_b = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box)
    tree = {"params": params, "opt": state}
    ck.save(box[0], 1, tree)
    saved = flat(_gather(tree))
    zeros = tree_map(torch.zeros_like, full())
    like_p = _shard(zeros, model, mesh_b, rules)
    like = {"params": like_p, "opt": opt.init(like_p)}
    got, _ = ck.restore(box[0], 1, like)
    back = flat(_gather(got))
    out["ada_elastic_mesh"] = {
        "equal": back.keys() == saved.keys() and all(
            np.array_equal(v, saved[k]) for k, v in back.items()),
        "local": [tuple(t["v"]["embed"]["vr"].to_local().shape)
                  for t in (state, got["opt"])]}
    if dist.get_rank() == 0:
        one = full()
        got1, _ = ck.restore(box[0], 1, {"params": one, "opt": opt.init(one)})
        got1 = flat(_gather(got1))
        out["ada_elastic_single"] = got1.keys() == saved.keys() and all(
            np.array_equal(v, saved[k]) for k, v in got1.items())


def _run(rank, init_url, mode, init_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_url, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    from torch.distributed.device_mesh import init_device_mesh

    with open(init_path, "rb") as f:
        init = pickle.load(f)
    out = {}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    _steps(init, mesh, out, mode)
    if mode == "ssm":
        _fit(mesh, out)
        _scan_local(out)
    else:
        _adafactor(init, mesh, out)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    rendezvous = "file://" + os.path.join(tempfile.mkdtemp(), "rdzv")
    mp.spawn(_run, args=(rendezvous, *sys.argv[1:4]), nprocs=WORLD)
