"""Training launcher of the port (``repro.launch.train``).

    python -m repro_torch.launch.train --arch minitron-4b --reduced \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch llama-100m --steps 30 \\
        --seq-len 256

    torchrun --nproc-per-node 256 ... -m repro_torch.launch.train \
        --arch qwen2.5-32b --production-mesh

``--arch`` takes a registered arch (``--reduced`` for its smoke config)
or ``llama-100m`` (``launch/train_100m.py``'s config).  The launcher wires
pipeline -> Trainer (checkpoint/restart, preemption guard, straggler
watchdog) and runs the reference's restart loop, printing the same JSON
after each run; a preemption restarts from the latest checkpoint.
``--preempt-file``: a flag file whose appearance preempts the run
(consumed by the restart).  ``--production-mesh`` trains on the 16x16
(data, model) mesh, ``--multi-pod`` on the 2x16x16 (pod, data, model)
one, with ``train_rules()``: run under ``torchrun`` (NCCL on the cards,
gloo with ``--device cpu``), whose world size must be the mesh's (else
exit 2 with a message naming both); each rank's pipeline gives its batch
rows (``host_id``/``num_hosts`` from its batch coordinate), and rank 0
prints.  Every arch trains there with its config's optimizer (AdamW, or
Adafactor for qwen1.5-110b and arctic-480b).  Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import make_pipeline
from repro_torch.distribution import train_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train_100m import CONFIG_100M
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train import fault
from repro_torch.train.trainer import batch_shard


def _production_mesh(args):
    """The mesh over torchrun's process group, or an error message."""
    import torch
    import torch.distributed as dist

    if "RANK" not in os.environ:
        return None, ("--production-mesh runs under torchrun (RANK and "
                      "WORLD_SIZE unset)")
    device = torch.device(args.device or "cuda").type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    try:
        return make_production_mesh(multi_pod=args.multi_pod,
                                    device=device), None
    except ValueError as e:
        return None, str(e)


def main(argv=None, *, on_step=None) -> int:
    """``on_step(step, metrics)``: called after every training step (the
    in-process hook of a caller that drives the loop)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ("llama-100m",),
                    required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the arch's smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--production-mesh", action="store_true",
                    help="train on the 16x16 production mesh (torchrun, "
                         "256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: 2x16x16 (512 ranks)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--preempt-file", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mesh = rules = None
    host_id, num_hosts, rank = 0, 1, 0
    if args.production_mesh:
        mesh, err = _production_mesh(args)
        if mesh is None:
            print(f"error: {err}", file=sys.stderr)
            return 2
        rules = train_rules()
        host_id, num_hosts = batch_shard(mesh, rules)
        rank = mesh.get_rank()

    if args.arch == "llama-100m":
        cfg = CONFIG_100M
    else:
        cfg = get_reduced(args.arch) if args.reduced else get_config(
            args.arch)
    model = build_model(cfg, args.device)
    pipe = make_pipeline(cfg, args.seq_len, args.global_batch,
                         host_id=host_id, num_hosts=num_hosts)
    tc = TrainConfig(steps=args.steps, lr=args.lr,
                     microbatches=args.microbatches, ckpt_dir=args.ckpt_dir)

    policy = fault.RestartPolicy(max_restarts=args.max_restarts,
                                 base_backoff_s=0.0)
    while True:
        trainer = Trainer(model, tc, mesh, rules, pipeline=pipe,
                          device=args.device,
                          preempt_file=args.preempt_file, on_step=on_step)
        out = trainer.fit()
        if rank == 0:
            print(json.dumps({"status": out["status"], "step": out["step"],
                              "final": out["metrics"][-1] if out["metrics"]
                              else {}}, indent=1))
        if out["status"] == "completed":
            return 0
        backoff = policy.next_backoff()
        if backoff is None:
            print("restart budget exhausted", file=sys.stderr)
            return 1
        if args.preempt_file and os.path.exists(args.preempt_file):
            os.remove(args.preempt_file)      # the notice is handled
        print(f"[fault] {out['status']} at step {out['step']}; "
              f"restarting (resume from checkpoint)")


if __name__ == "__main__":
    raise SystemExit(main())
