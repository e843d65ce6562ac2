"""Training launcher of the port (``repro.launch.train``).

    python -m repro_torch.launch.train --arch minitron-4b --reduced \\
        --device cpu --steps 3
    python -m repro_torch.launch.train --arch llama-100m --steps 30 \\
        --seq-len 256

``--arch`` takes a registered arch (``--reduced`` for its smoke config)
or ``llama-100m`` (``launch/train_100m.py``'s config).  The launcher wires
pipeline -> Trainer (checkpoint/restart, preemption guard, straggler
watchdog) on one device and runs the reference's restart loop, printing
the same JSON after each run; a preemption restarts from the latest
checkpoint.  ``--preempt-file``: a flag file whose appearance preempts the
run (consumed by the restart).  ``--production-mesh`` and ``--multi-pod``
raise: they need more than one GPU.  Runs on the GPU unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import make_pipeline
from repro_torch.launch.train_100m import CONFIG_100M
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train import fault


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
                    help="the production mesh: needs more than one GPU")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--preempt-file", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "--production-mesh and --multi-pod need more than one GPU "
            "(ROADMAP queue 1, item 1 (d)); the port trains on one device")

    if args.arch == "llama-100m":
        cfg = CONFIG_100M
    else:
        cfg = get_reduced(args.arch) if args.reduced else get_config(
            args.arch)
    model = build_model(cfg, args.device)
    pipe = make_pipeline(cfg, args.seq_len, args.global_batch)
    tc = TrainConfig(steps=args.steps, lr=args.lr,
                     microbatches=args.microbatches, ckpt_dir=args.ckpt_dir)

    policy = fault.RestartPolicy(max_restarts=args.max_restarts,
                                 base_backoff_s=0.0)
    while True:
        trainer = Trainer(model, tc, pipeline=pipe, device=args.device,
                          preempt_file=args.preempt_file, on_step=on_step)
        out = trainer.fit()
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
