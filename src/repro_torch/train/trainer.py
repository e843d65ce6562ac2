"""Trainer of the port (``repro.train.trainer``) on one device: the train
step with microbatch accumulation, global-norm clipping and the cosine
schedule, and the host loop with checkpoints, preemption and straggler
handling.

``make_train_step`` builds the step function; :class:`Trainer` wraps it
with the production loop.  Parameters are fp32 masters
(``cfg.param_dtype``) that the layers cast to the activation dtype at use.
The step updates the parameters and optimizer state IN PLACE and returns
them; its gradients live in the parameters' ``.grad`` and are freed after
the update.  A mesh (the reference's ``setup_sharded_state`` and its mesh
and rules arguments) waits for a second GPU (ROADMAP queue 1, item 1
(d)).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.optim import base as optim
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import fault

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation
    log_every: int = 10
    checkpoint_every: int = 50       # 0: none but a preemption's
    ckpt_dir: str = "repro_torch_ckpt"
    seed: int = 0


def make_train_step(model: Model, opt: optim.Optimizer, cfg: TrainConfig
                    ) -> Callable:
    """(params, opt_state, step, batch) -> (params, opt_state, metrics).

    ``batch``: {tokens, labels} (B, S), and frames (B, S_src, d) for
    enc-dec archs, on the model's device.  With ``cfg.microbatches`` > 1
    every key's leading dim is split and the microbatches' fp32 gradients
    are summed in ``.grad`` and divided by their count (bitwise the
    reference's sum of g / n for a power-of-two count; fp32 parameters
    only), and the metrics are the reference's: xent the microbatches'
    mean loss, aux 0.  The lr of step 0 is 0, as the reference's cosine
    schedule gives: its first step moves nothing."""
    lr_fn = optim.cosine_schedule(cfg.lr, cfg.warmup, cfg.steps)
    n_mb = cfg.microbatches

    def step_fn(params, opt_state, step: int, batch):
        leaves = optim.tree_leaves(params)
        if n_mb > 1 and any(p.dtype != torch.float32 for p in leaves):
            raise ValueError("microbatches > 1 accumulate in the fp32 "
                             "parameters' .grad: fp32 parameters only")
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            if n_mb > 1:
                rows = batch["tokens"].shape[0] // n_mb
                zero = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                loss = zero
                for i in range(n_mb):
                    mb = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    lmb, _ = model.loss(params, mb)
                    lmb.backward()
                    loss = loss + lmb.detach() / n_mb
                for p in leaves:
                    p.grad.div_(n_mb)
                metrics = {"xent": loss, "aux": zero}
            else:
                loss, metrics = model.loss(params, batch)
                loss.backward()
                loss = loss.detach()
                metrics = {k: v.detach() for k, v in metrics.items()}
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = optim.tree_map(lambda p: p.grad, params)
        _, gnorm = optim.clip_by_global_norm(grads, cfg.grad_clip)
        lr = lr_fn(step)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        for p in leaves:
            p.grad = None
        out = dict(metrics)
        out.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return params, opt_state, out

    return step_fn


class Trainer:
    """Production loop on one device: data -> step -> metrics, checkpoints
    and fault handling.  ``device`` None is the card (and raises without
    one); the model must live on the same device.  ``preempt_file``: a
    flag file whose appearance requests a checkpoint and exit, for
    schedulers that cannot signal.  ``on_step(step, metrics)`` is called
    after every step with the step's metrics as floats."""

    def __init__(self, model: Model, cfg: TrainConfig,
                 pipeline: Optional[SyntheticLM] = None, *,
                 device: DeviceLike = None,
                 preempt_file: Optional[str] = None,
                 on_step: Optional[Callable[[int, Dict[str, float]],
                                            None]] = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"trainer on {self.device}")
        self.model = model
        self.cfg = cfg
        self.pipeline = pipeline
        self.opt = optim.make_optimizer(model.cfg.optimizer)
        self.guard = fault.PreemptionGuard(flag_file=preempt_file,
                                           install_signal=False)
        self.watchdog = fault.StragglerWatchdog()
        self.on_step = on_step
        self.metrics_log: list = []
        self._step = make_train_step(model, self.opt, cfg)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, dtype=self.model.cfg.param_dtype)
        return params, self.opt.init(params)

    def restore_or_init(self, seed: int = 0):
        step0 = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        params, opt_state = self.init_state(seed)
        if step0 is None:
            return params, opt_state, 0
        state, extra = ckpt_lib.restore(
            self.cfg.ckpt_dir, step0, {"params": params, "opt": opt_state})
        return (state["params"], state["opt"],
                int(extra.get("next_step", step0)))

    # ------------------------------------------------------------------
    def fit(self, params=None, opt_state=None, start_step: int = 0,
            steps: Optional[int] = None) -> Dict[str, Any]:
        """Run steps ``start_step`` .. ``steps`` (default ``cfg.steps``).
        The pipeline's batch of each step goes to the device; an enc-dec
        arch's gets frames from ``batch_with_frames`` where it has none, as
        the reference's loop gives them."""
        if params is None:
            params, opt_state, start_step = self.restore_or_init(
                self.cfg.seed)
        total = steps if steps is not None else self.cfg.steps
        step = start_step
        status = "completed"
        while step < total:
            t0 = time.monotonic()
            host = self.pipeline.batch(step)
            if self.model.cfg.is_encdec and "frames" not in host:
                host = self.pipeline.batch_with_frames(
                    step, self.model.cfg.d_model)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in host.items()}
            params, opt_state, metrics = self._step(params, opt_state, step,
                                                    batch)
            dur = time.monotonic() - t0
            action = self.watchdog.observe(step, dur)
            logged = step % self.cfg.log_every == 0 or step == total - 1
            if logged or self.on_step is not None:
                m = {k: float(v) for k, v in metrics.items()}
                m.update({"step": step, "sec": dur})
                if logged:
                    self.metrics_log.append(m)
                if self.on_step is not None:
                    self.on_step(step, m)
            step += 1
            every = self.cfg.checkpoint_every
            want_ckpt = every > 0 and (step % every == 0 or step == total)
            if self.guard.check() or \
               action == fault.ACTION_CHECKPOINT_AND_RESHARD:
                ckpt_lib.save(self.cfg.ckpt_dir, step,
                              {"params": params, "opt": opt_state},
                              extra={"next_step": step, "reason": action})
                status = ("preempted" if self.guard.check()
                          else "straggler_reshard")
                break
            if want_ckpt:
                ckpt_lib.save(self.cfg.ckpt_dir, step,
                              {"params": params, "opt": opt_state},
                              extra={"next_step": step})
        return {"params": params, "opt_state": opt_state, "step": step,
                "status": status, "metrics": self.metrics_log}
