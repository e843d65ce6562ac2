"""End-to-end training example of the port: a ~100M-parameter llama-style
model (``llama-100m``: 12 layers, d 640, 10 heads on 5 KV heads of 64,
SwiGLU, vocab 32000) trained with the whole stack (trainer, deterministic
pipeline, checkpoints, straggler watchdog), as the reference's
``examples/train_100m.py``; asserts that the loss falls.

    python -m repro_torch.launch.train_100m               # 300 steps
    python -m repro_torch.launch.train_100m --steps 20    # smoke
    python -m repro_torch.launch.train_100m --arch minitron-4b --device cpu

Runs on the GPU unless ``--device cpu`` is given; ``--arch`` trains a
reduced registered arch instead.
"""
from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data import make_pipeline
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, Trainer

CONFIG_100M = ModelConfig(
    name="llama-100m",
    family="dense",
    num_layers=12,
    d_model=640,
    num_heads=10,
    num_kv_heads=5,
    d_ff=1792,
    vocab_size=32000,
    head_dim=64,
    attn_type="full",
    act="silu",
    glu=True,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--arch", default=None,
                    help="use a reduced registered arch config instead")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.arch else CONFIG_100M
    model = build_model(cfg, args.device)
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M")
    pipe = make_pipeline(cfg, args.seq_len, args.global_batch, seed=0)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train100m_")
    tr = Trainer(model,
                 TrainConfig(steps=args.steps, lr=args.lr,
                             warmup=max(args.steps // 20, 5),
                             log_every=max(args.steps // 20, 1),
                             checkpoint_every=max(args.steps // 3, 10),
                             ckpt_dir=ckpt_dir),
                 pipeline=pipe, device=args.device)
    out = tr.fit()
    first, last = out["metrics"][0], out["metrics"][-1]
    print(json.dumps({"status": out["status"], "steps": out["step"],
                      "loss_first": round(first["loss"], 3),
                      "loss_last": round(last["loss"], 3),
                      "tokens_per_step": args.seq_len * args.global_batch,
                      "ckpt_dir": ckpt_dir}, indent=1))
    assert last["loss"] < first["loss"], "loss must decrease"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
