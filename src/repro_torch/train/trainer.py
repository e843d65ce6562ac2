"""Trainer of the port (``repro.train.trainer``): the train step with
microbatch accumulation, global-norm clipping and the cosine schedule, and
the host loop with checkpoints, preemption and straggler handling, on one
device or on a ``DeviceMesh``.

``make_train_step`` builds the step function; :class:`Trainer` wraps it
with the production loop.  Parameters are fp32 masters
(``cfg.param_dtype``) that the layers cast to the activation dtype at use.
The step updates the parameters and optimizer state IN PLACE and returns
them; its gradients live in the parameters' ``.grad`` and are freed after
the update.

On a mesh (``Trainer(model, cfg, mesh, rules)``), ``setup_sharded_state``
makes every parameter a DTensor laid out by its logical spec under the
rules (``Model.logical_specs``, ``distribution.partitioning``), and each
optimizer leaf the DTensor of its parameter's layout (Adafactor's factored
statistics: its layout less the dim each averages over).  The step then
runs the same clip, schedule and optimizer on DTensors: torch's DTensor
ops insert the collectives, the attention kernels run on each rank's local
heads (``models.attention._attend``), the Mamba scan's on its own rows and
channels (``partitioning.channel_local``), and both optimizers update each
rank's local shards, Adafactor's means over split dims summed over their
mesh dims.  Every family (dense, MoE/MLA, SSM, hybrid, enc-dec) and both
optimizers run on a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distribution import partitioning as part
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


def _mesh_ops(leaf):
    """DTensor ops on a mesh take plain tensors (masks, positions, the
    norm's constants) as replicated: the context that lets them."""
    if not part.is_dtensor(leaf):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def make_train_step(model: Model, opt: optim.Optimizer, cfg: TrainConfig,
                    *, residual_spec=None) -> Callable:
    """(params, opt_state, step, batch) -> (params, opt_state, metrics).

    ``batch``: {tokens, labels} (B, S), and frames (B, S_src, d) for
    enc-dec archs, on the model's device.  With ``cfg.microbatches`` > 1
    every key's leading dim is split and the microbatches' fp32 gradients
    are summed in ``.grad`` and divided by their count (bitwise the
    reference's sum of g / n for a power-of-two count; fp32 parameters
    only), and the metrics are the reference's: xent the microbatches'
    mean loss, aux 0.  The lr of step 0 is 0, as the reference's cosine
    schedule gives: its first step moves nothing.  DTensor parameters
    (a mesh) take a batch of DTensors; ``residual_spec`` pins the
    decoder's residual layout (sequence parallelism)."""
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
        with _mesh_ops(leaves[0]):
            return _step(params, opt_state, step, batch, leaves)

    def _step(params, opt_state, step, batch, leaves):
        try:
            if n_mb > 1:
                rows = batch["tokens"].shape[0] // n_mb
                zero = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                loss = zero
                for i in range(n_mb):
                    mb = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    lmb, _ = model.loss(params, mb,
                                        residual_spec=residual_spec)
                    lmb.backward()
                    loss = loss + lmb.detach() / n_mb
                for p in leaves:
                    p.grad.div_(n_mb)
                metrics = {"xent": loss, "aux": zero}
            else:
                loss, metrics = model.loss(params, batch,
                                           residual_spec=residual_spec)
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
        out.update({"loss": loss, "grad_norm": gnorm})
        out = {k: v.full_tensor() if part.is_dtensor(v) else v
               for k, v in out.items()}
        out["lr"] = lr
        return params, opt_state, out

    return step_fn


def setup_sharded_state(model: Model, opt: optim.Optimizer, mesh,
                        rules: part.ShardingRules, seed: int = 0
                        ) -> Tuple[PyTree, PyTree, PyTree, PyTree]:
    """Parameters and optimizer state as DTensors on ``mesh``: each leaf is
    drawn from the seeded generator exactly as on one device and its local
    shard kept at once (``Model.init``'s ``place``: no more than one
    layer's full leaves exist at a time).  Optimizer leaves take the
    placements of the parameter they mirror (an Adafactor statistic, less
    the dim it averages over); the step count is replicated.  Returns (params, opt_state, param placements, opt placements)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen, dtype=model.cfg.param_dtype,
                        place=lambda t, s: part.distribute(
                            t, mesh, rules.shard(mesh, s, t.shape)))
    opt_state = opt.init(params)
    placements = lambda tree: optim.tree_map(lambda t: list(t.placements),
                                             tree)
    return params, opt_state, placements(params), placements(opt_state)


def batch_shard(mesh, rules: part.ShardingRules) -> Tuple[int, int]:
    """(index, count) of this rank's batch rows on ``mesh``: its
    coordinate over the mesh dims that "batch" maps to, major first (the
    pipeline's ``host_id`` and ``num_hosts``)."""
    sizes = part.mesh_sizes(mesh)
    axes = part.sanitize_spec((rules.physical("batch"),), mesh)[0]
    axes = () if axes is None else axes if isinstance(axes, tuple) \
        else (axes,)
    index, count = 0, 1
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
        count *= sizes[a]
    return index, count


class Trainer:
    """Production loop: data -> step -> metrics, checkpoints and fault
    handling, on one device or, with ``mesh`` (a ``DeviceMesh``) and
    ``rules`` (``train_rules()`` by default), on a mesh of ranks.
    ``device`` None is the card (and raises without one); the model must
    live on the same device.  On a mesh, the pipeline gives this rank's
    batch rows when its ``num_hosts`` is ``batch_shard(mesh, rules)``'s
    count, else the whole batch, of which each rank keeps its rows; with
    ``act_seq`` sharded the residual is pinned to ("batch", "act_seq",
    None).  ``preempt_file``: a flag file whose appearance requests a
    checkpoint and exit, for schedulers that cannot signal.
    ``on_step(step, metrics)`` is called after every step with the step's
    metrics as floats."""

    def __init__(self, model: Model, cfg: TrainConfig, mesh=None,
                 rules: Optional[part.ShardingRules] = None,
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
        self.mesh = mesh
        self.rules = rules or (part.train_rules() if mesh is not None
                               else part.single_device_rules())
        self.pipeline = pipeline
        self.opt = optim.make_optimizer(model.cfg.optimizer)
        self.guard = fault.PreemptionGuard(flag_file=preempt_file,
                                           install_signal=False)
        self.watchdog = fault.StragglerWatchdog()
        self.on_step = on_step
        self.metrics_log: list = []
        residual_spec = None
        if mesh is not None and self.rules.rules.get("act_seq"):
            residual_spec = self.rules.spec(("batch", "act_seq", None))
        self._step = make_train_step(model, self.opt, cfg,
                                     residual_spec=residual_spec)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        if self.mesh is not None:
            return setup_sharded_state(self.model, self.opt, self.mesh,
                                       self.rules, seed)[:2]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, dtype=self.model.cfg.param_dtype)
        return params, self.opt.init(params)

    def _to_device(self, host: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch on the device; on a mesh, DTensors with the batch
        dim laid out by the rules."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in host.items()}
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import DTensor

        mesh, rules = self.mesh, self.rules
        count = batch_shard(mesh, rules)[1]
        local = count > 1 and getattr(self.pipeline, "num_hosts", 1) == count
        out = {}
        for k, t in batch.items():
            logical = ("batch",) + (None,) * (t.ndim - 1)
            shape = ((t.shape[0] * count,) if local else t.shape[:1]) \
                + tuple(t.shape[1:])
            place = rules.shard(mesh, logical, shape)
            out[k] = (DTensor.from_local(t, mesh, place, run_check=False)
                      if local else part.distribute(t, mesh, place))
        return out

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
            batch = self._to_device(host)
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
