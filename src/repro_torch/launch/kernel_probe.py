"""Probes of the port's kernels that the smoke run does not hold: where a
model's bf16 rounding comes from, and how the ragged decode grid's split
target moves its time.

    python -m repro_torch.launch.kernel_probe rounding \\
        [--arch hymba-1.5b] [--seeds 0 1 2] [--prompt 1100] [--reduced] \\
        [--device cpu]

builds the model at full width (``--reduced``: its reduced config) with
random bf16 weights from each seed and runs one prompt of ``--prompt``
tokens and 5 decode steps on several paths, each fed the fp32 plain
path's argmax, as ``chip_smoke.py``'s reference check of an SSM model
does (the same weights, prompt and tokens).  The bf16 paths differ in
which kernels run: all of them, none (the model's plain path), each one
alone put back on its plain version, and each one alone.  Prints, per
path, its largest distance from the fp32 plain path (max |dlogit| over
the vocabulary relative to the largest |logit|, over the six positions)
and its ratio to the bf16 plain path's distance, the model's rounding
floor, and by position its distances from the fp32 and from the bf16
plain path.  On the CPU every wrapper takes its plain version, so all paths
agree there: the CPU run checks the probe, not the kernels.

    python -m repro_torch.launch.kernel_probe ragged-splits

times the ragged decode kernel at split targets of 1-16 launched blocks
per SM (the wrapper's ``_BLOCKS_PER_SM``) at granite-34b's (48 query heads
on 1 KV head, D 128), minitron-4b's (24 on 8) and hymba-1.5b's (25 on 5,
D 64) heads: 8 slots of 1000-1 live rows, one dead, bf16, two turns over
the targets, the L2 flushed before each launch.  Needs a CUDA card.

    python -m repro_torch.launch.kernel_probe scan-clusters

times the scan's backward (``mamba_scan_bwd``, bf16) at falcon-mamba-7b's
and hymba-1.5b's training layers with its dB/dC fold in thread-block
clusters of 1, 2, 4 and 8 blocks, two turns, beside the clusters of each
size the card holds at once and the waves of clusters the grid takes;
the plan (``scan_bwd_plan``) picks the largest size that adds no wave.
Outputs at every size are held to the plan's within the kernel
tolerance.  Needs a CUDA card.

    python -m repro_torch.launch.kernel_probe train-spread \
        [--arch falcon-mamba-7b] [--lr 3e-4]

trains the model as ``chip_smoke.py``'s SSM training phase does (falcon-
mamba-7b cut to 32 layers at B 4 x S 1024, hymba-1.5b whole at B 2 x S
2048; fp32 masters, bf16, AdamW, 8 steps, 2 of warmup to ``--lr``) once
for each of several scan backwards that differ only in the order of
their fp32 sums: the kernel as planned, its dB/dC fold in clusters of 1
and of 8, and the plain backward.  Prints each run's losses and grad
norms, and whether its last loss is below its first and step 1's (the
phase's check).  Needs a CUDA card.

    python -m repro_torch.launch.kernel_probe collectives [--device cpu]

runs each collective that a sharded train step issues in a gloo world of
4 ranks on the one card (CUDA tensors; ``--device cpu``: host tensors),
each in a world of its own so that a crash names it: the c10d
collectives on the world's group, then DTensor's all-gather, all-reduce
and reduce-scatter over the dims of a 2 x 2 mesh.  NCCL takes one rank a
device, so gloo is the only way for ranks to share a card.

Prints one JSON object on its last line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import time
from typing import Dict, List, Sequence

import torch

from repro_torch.device import resolve_device

STEPS = 5
PROMPT_SEED = 2           # chip_smoke.py's reference-check prompt
SPLIT_TARGETS = (1, 2, 4, 8, 16)
SPLIT_LENGTHS = (1000, 517, 129, 1, 64, 999, 700, 333)
SPLIT_LIVE = (1, 1, 1, 1, 1, 1, 0, 1)
SPLIT_HEADS = {"granite G48": (48, 1, 128), "minitron G3": (24, 8, 128),
               "hymba G5": (25, 5, 64)}
# the scan's training layers (chip_smoke.SCAN_TRAIN_CASES): B, S, d_in, N
SCAN_LAYERS = {"falcon-mamba-7b": (4, 1024, 8192, 16),
               "hymba-1.5b": (2, 2048, 3200, 16)}
SCAN_CLUSTERS = (1, 2, 4, 8)
# chip_smoke.SSM_TRAIN: B, S, layers (None: all); chip_smoke.TRAIN_STEPS
TRAIN_SPREAD = {"falcon-mamba-7b": (4, 1024, 32), "hymba-1.5b": (2, 2048, None)}
TRAIN_STEPS = 8


def _mamba_step_plain(x1, conv, h, *args, live=None):
    """The Mamba step wrapper's contract (conv and h advanced in place,
    dead rows unchanged) on its plain version."""
    from repro_torch.kernels.mamba_scan.ref import mamba_step_ref
    out, new_conv, new_h = mamba_step_ref(x1, conv, h, *args, live=live)
    conv.copy_(new_conv)
    h.copy_(new_h)
    return out


def _plain_versions():
    """(module, attribute, plain function) of each kernel's call site on the
    model's path: the attention module binds the two attention wrappers by
    name, the SSM module calls the Mamba wrappers through their module."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.kernels.ragged_decode.ref import \
        ragged_decode_attention_ref
    from repro_torch.models import attention as A
    return {"flash_attention": (A, "flash_attention", flash_attention_ref),
            "ragged_decode": (A, "ragged_decode_attention",
                              ragged_decode_attention_ref),
            "mamba_step": (ms, "mamba_step", _mamba_step_plain),
            "mamba_scan": (ms, "mamba_scan", mamba_scan_ref)}


@contextlib.contextmanager
def plain(names: Sequence[str]):
    """Inside the block the kernels ``names`` run their plain versions on
    the model's kernel path; the others launch as ever."""
    swaps = [_plain_versions()[n] for n in names]
    kept = [getattr(mod, attr) for mod, attr, _ in swaps]
    try:
        for mod, attr, fn in swaps:
            setattr(mod, attr, fn)
        yield
    finally:
        for (mod, attr, _), fn in zip(swaps, kept):
            setattr(mod, attr, fn)


def rounding_paths(kernels: Sequence[str]) -> Dict[str, tuple]:
    """name -> (use_kernels, kernels on their plain versions) of each bf16
    path of the probe, for the model's ``kernels``."""
    paths = {"kernels": (True, ()), "plain path": (False, ()),
             "kernels on plain versions": (True, tuple(kernels))}
    for k in kernels:
        paths[f"all but {k}"] = (True, (k,))
    for k in kernels:
        paths[f"{k} alone"] = (True, tuple(x for x in kernels if x != k))
    return paths


def model_kernels(cfg) -> List[str]:
    """The kernels a model's serving path runs."""
    out = []
    if not cfg.attention_free:
        out += ["flash_attention", "ragged_decode"]
    if cfg.attention_free or cfg.hybrid_parallel:
        out += ["mamba_step", "mamba_scan"]
    return out


def _rel(a, ref) -> float:
    return ((a - ref).abs().max() / ref.abs().max()).item()


def rounding(arch: str, seeds: Sequence[int], S: int, device,
             reduced: bool = False) -> dict:
    """The rounding probe (module docstring) for each seed; returns
    {seed: {path: {"from_fp32": per position, "from_plain": per position
    (from the bf16 plain path), "largest": the largest from fp32, "ratio":
    that over the bf16 plain path's}}}."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.model import build_model
    cfg = (get_reduced if reduced else get_config)(arch)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = build_model(cfg, device)
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"), device)
    paths = rounding_paths(model_kernels(cfg))
    V = cfg.vocab_size
    out = {}
    for seed in seeds:
        params = model.init(torch.Generator(device=device).manual_seed(seed))
        p32 = fp32_copy(params)
        gen = torch.Generator(device=device).manual_seed(PROMPT_SEED)
        toks = torch.randint(1, V, (1, S), generator=gen, device=device,
                             dtype=torch.int32)
        runs = [(name, model, params, kern, off)
                for name, (kern, off) in paths.items()]
        runs.append(("fp32 plain path", m32, p32, False, ()))
        caches = [m.init_cache(1, S + STEPS + 3) for _, m, _, _, _ in runs]
        logits = [None] * len(runs)
        rows = []
        for step in range(STEPS + 1):
            if step:
                nxt = logits[-1].argmax(-1).to(torch.int32)[:, None]
            for i, (_, m, p, kern, off) in enumerate(runs):
                with plain(off):
                    if step == 0:
                        logits[i], caches[i] = m.prefill(
                            p, {"tokens": toks}, caches[i], use_kernels=kern)
                    else:
                        logits[i], caches[i] = m.decode_step(
                            p, caches[i], nxt, use_kernels=kern)
            rows.append([x.float()[..., :V] for x in logits])
        plain_i = list(paths).index("plain path")
        res = {}
        for i, (name, *_) in enumerate(runs[:-1]):
            res[name] = {"from_fp32": [_rel(r[i], r[-1]) for r in rows],
                         "from_plain": [_rel(r[i], r[plain_i])
                                        for r in rows]}
            res[name]["largest"] = max(res[name]["from_fp32"])
        floor = res["plain path"]["largest"]
        for r in res.values():
            r["ratio"] = r["largest"] / floor
        out[seed] = res
        del params, p32, caches, logits, rows
    return out


def fp32_copy(tree):
    """An fp32 copy of a param tree."""
    if isinstance(tree, dict):
        return {k: fp32_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp32_copy(v) for v in tree]
    return tree.float()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` over ``reps`` launches timed with CUDA
    events, each after a 256 MB write that evicts the L2, queued behind a
    sleep that outlasts the host's enqueue (``chip_smoke.time_ms``)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int((reps * (host_s + 2e-4) + 5e-3) * 1.98e9))
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def ragged_splits(device) -> dict:
    """The split-target sweep (module docstring); returns {head shape:
    {target: [ms of each turn], ...}} and each shape's plan per target."""
    from repro_torch.kernels.ragged_decode import ops as rd
    if device.type != "cuda":
        raise ValueError("ragged-splits times the kernel: it needs a CUDA "
                         "card")
    gen = torch.Generator(device=device).manual_seed(1)
    T = -(-max(SPLIT_LENGTHS) // 32) * 32
    lens = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=device)
    live = torch.tensor(SPLIT_LIVE, dtype=torch.bool, device=device)
    cases = {}
    for name, (Hq, Hkv, D) in SPLIT_HEADS.items():
        q, k, v = (torch.randn((8, n, h, D), generator=gen, device=device)
                   .to(torch.bfloat16) for n, h in ((1, Hq), (2048, Hkv),
                                                    (2048, Hkv)))
        cases[name] = (q, k[:, :T], v[:, :T])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    keep = rd._BLOCKS_PER_SM
    times: Dict[str, Dict[int, list]] = {n: {} for n in cases}
    plans: Dict[str, Dict[int, list]] = {n: {} for n in cases}
    try:
        for _ in range(2):
            for target in SPLIT_TARGETS:
                rd._BLOCKS_PER_SM = target
                for name, (q, k, v) in cases.items():
                    times[name].setdefault(target, []).append(time_ms(
                        lambda: rd.ragged_decode_attention(q, k, v, lens,
                                                           live=live)))
                    Hq, Hkv, _ = SPLIT_HEADS[name]
                    chunk, n = rd.split_plan(8, Hq, Hkv, T, sms)
                    groups = rd.head_groups(Hq // Hkv)[0]
                    plans[name][target] = [chunk, 8 * Hkv * groups * n]
    finally:
        rd._BLOCKS_PER_SM = keep
    return {"ms": times, "chunk_and_blocks": plans}


def scan_clusters(device) -> dict:
    """The cluster sweep of the scan's backward (module docstring);
    returns {layer: {"ms": {size: [ms of each turn]}, "held": clusters of
    each size the card holds, "waves": {size: waves}, "plan": the plan's
    size}}."""
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import softplus
    if device.type != "cuda":
        raise ValueError("scan-clusters times the kernel: it needs a CUDA "
                         "card")
    gen = torch.Generator(device=device).manual_seed(12)
    plan_of = ms.bwd_plan
    out = {}
    try:
        for name, (B, S, D, N) in SCAN_LAYERS.items():
            a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                           device=device)).expand(D, N)
            a_log = a_log.contiguous()
            d = torch.ones(D, dtype=torch.float32, device=device)
            x = torch.randn((B, S, D), generator=gen, device=device)
            dt = softplus(torch.randn((B, S, D), generator=gen,
                                      device=device) - 4.0)
            dbc = torch.randn((B, S, 256 + 2 * N), generator=gen,
                              device=device).to(torch.bfloat16)
            gy = torch.randn((B, S, D), generator=gen, device=device)
            ins = (x.to(torch.bfloat16), dt, dbc[..., 256:256 + N],
                   dbc[..., 256 + N:], a_log, d)
            bounds = ms.mamba_scan(*ins, bounds=True)[2]
            p = plan_of(B, D, N, torch.bfloat16, device)
            want = ms.mamba_scan_bwd(*ins, bounds, gy)
            held = ms.bwd_cluster_slots(N, torch.bfloat16)
            res = {"ms": {}, "held": dict(zip(SCAN_CLUSTERS, held)),
                   "waves": {}, "plan": p.cluster}
            for turn in range(2):
                for c in SCAN_CLUSTERS:
                    per_row = -(-p.blocks // c)
                    ms.bwd_plan = (lambda *a, c=c, n=per_row, **k: plan_of(
                        *a, **k)._replace(cluster=c, grid_x=n * c,
                                          clusters=n))
                    got = ms.mamba_scan_bwd(*ins, bounds, gy)
                    for g, w in zip(got, want):
                        tol = 2e-2 if g.dtype == torch.bfloat16 else 1e-4
                        err = (g.float() - w.float()).abs().max().item()
                        if err > tol * max(w.float().abs().max().item(),
                                           1e-6):
                            raise RuntimeError(
                                f"scan backward {name} in clusters of {c} "
                                f"differs from the plan's by {err:.3e}")
                    res["ms"].setdefault(c, []).append(time_ms(
                        lambda: ms.mamba_scan_bwd(*ins, bounds, gy), 20))
                    res["waves"][c] = -(-B * per_row // held[
                        SCAN_CLUSTERS.index(c)])
            out[name] = res
            del x, dt, dbc, gy, ins, bounds, want
    finally:
        ms.bwd_plan = plan_of
    return out


def train_spread(arch: str, lr: float, device) -> dict:
    """The training runs of the module docstring's train-spread; returns
    {backward: {"loss": [...], "grad_norm": [...], "falls": bool}}."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import selective_scan_bwd_ref
    from repro_torch.models.model import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainConfig, make_train_step
    if device.type != "cuda":
        raise ValueError("train-spread trains at full width: it needs a "
                         "CUDA card")
    B, S, layers = TRAIN_SPREAD[arch]
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    pipe = make_pipeline(full, S, B, seed=0)
    batches = [{k: torch.as_tensor(v, device=device)
                for k, v in pipe.batch(s).items()}
               for s in range(TRAIN_STEPS)]
    plan_of, bwd_of = ms.bwd_plan, ms.mamba_scan_bwd

    def clusters_of(c):
        def plan(*a, **k):
            p = plan_of(*a, **k)
            n = -(-p.blocks // c)
            return p._replace(cluster=c, grid_x=n * c, clusters=n)
        return plan

    runs = {"the kernel as planned": {},
            "clusters of 1": {"bwd_plan": clusters_of(1)},
            "clusters of 8": {"bwd_plan": clusters_of(8)},
            "the plain backward": {"mamba_scan_bwd": selective_scan_bwd_ref}}
    out = {}
    try:
        for name, swaps in runs.items():
            ms.bwd_plan, ms.mamba_scan_bwd = plan_of, bwd_of
            for attr, fn in swaps.items():
                setattr(ms, attr, fn)
            model = build_model(cfg, device)
            params = model.init(torch.Generator(device=device).manual_seed(0),
                                dtype=cfg.param_dtype)
            opt = make_optimizer(cfg.optimizer)
            step_fn = make_train_step(model, opt, TrainConfig(
                steps=TRAIN_STEPS, lr=lr, warmup=2))
            state = opt.init(params)
            loss, norm = [], []
            for step, batch in enumerate(batches):
                params, state, m = step_fn(params, state, step, batch)
                loss.append(m["loss"].item())
                norm.append(m["grad_norm"].item())
            out[name] = {"loss": loss, "grad_norm": norm,
                         "falls": loss[-1] < min(loss[0], loss[1])}
            del model, params, state, step_fn, opt
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ms.bwd_plan, ms.mamba_scan_bwd = plan_of, bwd_of
    return out


COLLECTIVES = ("barrier", "all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "dtensor_all_gather",
               "dtensor_all_reduce", "dtensor_reduce_scatter")
_WORLD = 4


def _collective(rank: int, name: str, init: str, device: str) -> None:
    """One rank of ``collectives``' world for ``name``."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=_WORLD,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.full((8, 4), float(rank + 1), device=device)
    if name == "barrier":
        dist.barrier()
    elif name == "all_reduce":
        dist.all_reduce(x)
    elif name == "broadcast":
        dist.broadcast(x, 0)
    elif name == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(_WORLD)], x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(
            torch.empty((8 * _WORLD, 4), device=device), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty((2, 4), device=device), x)
    elif name == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif name.startswith("dtensor_"):
        mesh = init_device_mesh(device, (2, 2),
                                mesh_dim_names=("data", "model"))
        whole, split = [Replicate(), Replicate()], [Shard(0), Shard(1)]
        if name == "dtensor_all_gather":
            distribute_tensor(x, mesh, split,
                              src_data_rank=None).redistribute(mesh, whole)
        else:
            part = DTensor.from_local(x, mesh, [Partial(), Partial()])
            part.redistribute(mesh, whole if name == "dtensor_all_reduce"
                              else split)
    else:
        raise ValueError(f"no collective {name}")
    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


def collectives(device: torch.device) -> Dict[str, str]:
    """{collective: "ok" or how its world ended} (``COLLECTIVES``)."""
    import socket

    import torch.multiprocessing as mp

    out = {}
    for name in COLLECTIVES:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            init = f"tcp://localhost:{s.getsockname()[1]}"
        try:
            mp.spawn(_collective, args=(name, init, device.type),
                     nprocs=_WORLD)
            out[name] = "ok"
        except Exception as e:          # a rank's crash is the finding
            out[name] = f"{type(e).__name__}: {str(e).strip()[-200:]}"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("rounding", "ragged-splits",
                                      "scan-clusters", "train-spread",
                                      "collectives"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--prompt", type=int, default=1100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    doc = {"probe": args.probe,
           "card": card_line() if device.type == "cuda" else "cpu"}
    if args.probe == "rounding":
        res = rounding(args.arch, args.seeds, args.prompt, device,
                       args.reduced)
        for seed, paths in res.items():
            for name, r in paths.items():
                print(f"{args.arch} seed {seed} {name}: largest distance "
                      f"from the fp32 plain path {r['largest']:.4e}, "
                      f"{r['ratio']:.4f}x the bf16 floor; by position "
                      f"from fp32 " + " ".join(
                          f"{x:.3e}" for x in r["from_fp32"])
                      + "; from the bf16 plain path " + " ".join(
                          f"{x:.3e}" for x in r["from_plain"]), flush=True)
        doc.update(arch=args.arch, prompt=args.prompt, reduced=args.reduced,
                   seeds={str(s): p for s, p in res.items()})
    elif args.probe == "train-spread":
        res = train_spread(args.arch, args.lr, device)
        for name, r in res.items():
            print(f"{args.arch} lr {args.lr:g}, {name}: losses "
                  + " ".join(f"{x:.5f}" for x in r["loss"])
                  + "; grad norms " + " ".join(
                      f"{x:.2f}" for x in r["grad_norm"])
                  + f"; last below the first and step 1's: {r['falls']}",
                  flush=True)
        doc.update(arch=args.arch, lr=args.lr, runs=res)
    elif args.probe == "collectives":
        res = collectives(device)
        for name, r in res.items():
            print(f"gloo, {_WORLD} ranks, {device.type} tensors, {name}: "
                  f"{r}", flush=True)
        doc.update(backend="gloo", ranks=_WORLD, tensors=device.type,
                   collectives=res)
    elif args.probe == "scan-clusters":
        res = scan_clusters(device)
        for name, r in res.items():
            for c, t in r["ms"].items():
                print(f"mamba_scan_bwd {name} in clusters of {c}: "
                      f"{r['held'][c]} held at once, {r['waves'][c]} waves; "
                      f"ms " + ", ".join(f"{x:.4f}" for x in t)
                      + (" (the plan's)" if c == r["plan"] else ""),
                      flush=True)
        doc.update(layers=res)
    else:
        res = ragged_splits(device)
        for name, per in res["ms"].items():
            for target, t in per.items():
                chunk, blocks = res["chunk_and_blocks"][name][target]
                print(f"ragged_decode split target {target} blocks/SM, "
                      f"{name}: chunk {chunk}, {blocks} blocks; ms "
                      + ", ".join(f"{x:.4f}" for x in t), flush=True)
        doc.update(res)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
