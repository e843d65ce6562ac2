"""The port's training path against the reference's, on the reduced dense
configs with the JAX init's fp32 weights carried over by
``params_from_jax(..., dtype=float32)`` (the training masters).

- ``Model.loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's ``Model.loss`` on minitron-, qwen2.5-, granite- and
  chameleon-reduced (QKV biases and QK-norm scales drawn from a seeded
  numpy normal on both sides, so that a path that skipped them would
  show).  fp32 activations: loss within 1e-5 relative, each gradient leaf
  within 1e-4 of its largest magnitude (the reference's stacked layer
  grads unstacked); bf16 activations: loss within 2e-2 relative.
- Three steps of ``make_train_step`` against the reference's (AdamW, lr
  1e-3, warmup 1, fp32): parameters within 1e-5, and the norm scales
  within 1e-6, so that a missing decay of the stacked per-layer scales
  (1e-4 per step at this lr) would show; the same with Adafactor on
  qwen1.5-reduced (its full config's optimizer), and with 2 microbatches
  against the reference's 2 microbatches.
- The family the port does not train yet (enc-dec) raises, naming the
  ROADMAP item that brings it (SSM and hybrid training:
  ``test_torch_train_ssm.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.data import make_pipeline as jax_make_pipeline  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import make_optimizer, tree_leaves  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402

LOSS_FP32_TOL = 1e-5
GRAD_FP32_TOL = 1e-4
LOSS_BF16_TOL = 2e-2
PARAM_TOL = 1e-5
NORM_TOL = 1e-6
DENSE = ("minitron-4b", "qwen2.5-32b", "granite-34b", "chameleon-34b")
_DRAWN = ("bq", "bk", "bv", "q_norm", "k_norm")


def _pair(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=dtype, **over)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=dtype, **over)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, strip(jm.init(jax.random.key(5))))
    attn = jp["decoder"]["scanned"]["attn"]
    rng = np.random.default_rng(21)
    for name in _DRAWN:
        if name in attn:
            base = 1.0 if name.endswith("norm") else 0.0
            attn[name] = (base + 0.5 * rng.normal(size=attn[name].shape)
                          ).astype(attn[name].dtype)
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jp, tcfg, "cpu", dtype=torch.float32)
    return jm, jax.tree.map(jnp.asarray, jp), tm, tp


def _batch(cfg, B=2, S=24, step=0):
    b = jax_make_pipeline(cfg, S, B, seed=3).batch(step)
    b["labels"][0, -3:] = -1                   # masked positions
    return b


def _pairs(tp, jtree):
    """(name, port tensor, reference array) for every port leaf; a decoder
    layer's leaf against its slice of the reference's stacked leaf."""
    out = []

    def walk(t, j, path, layer=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, j[k], path + (k,), layer)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, j, path + (i,), i)
        else:
            arr = np.asarray(j, np.float32)
            out.append((".".join(map(str, path)), t,
                        arr if layer is None else arr[layer]))

    for key, t in tp.items():
        j = jtree[key]
        if key == "decoder":
            walk(t["layers"], j["scanned"], ("decoder", "layers"))
        else:
            walk(t, j, (key,))
    return out


def _port_grads(tm, tp, batch):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = tm.loss(tp, tb)
    loss.backward()
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference_fp32(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    loss, metrics = _port_grads(tm, tp, batch)
    assert abs(loss.item() - float(jloss)) <= LOSS_FP32_TOL * abs(float(jloss))
    assert abs(metrics["xent"].item() - float(jmet["xent"])) <= \
        LOSS_FP32_TOL * abs(float(jmet["xent"]))
    assert metrics["aux"].item() == 0.0
    grads = {k: v for k, v in jgrads.items()}
    for name, t, want in _pairs(tp, grads):
        got = t.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-8)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_FP32_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b"])
def test_loss_matches_reference_bf16(arch):
    jm, jp, tm, tp = _pair(arch, dtype="bfloat16")
    batch = _batch(tm.cfg)
    jloss, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    loss, _ = _port_grads(tm, tp, batch)
    assert abs(loss.item() - float(jloss)) <= LOSS_BF16_TOL * abs(float(jloss))
    assert all(t.grad is not None and t.grad.isfinite().all()
               for t in tree_leaves(tp))


def _train_both(arch, steps=3, microbatches=1, **over):
    jm, jp, tm, tp = _pair(arch, **over)
    kw = dict(steps=10, lr=1e-3, warmup=1, microbatches=microbatches)
    jstep = jax.jit(jax_make_train_step(
        jm, jax_make_optimizer(jm.cfg.optimizer), JaxTrainConfig(**kw)))
    opt = make_optimizer(tm.cfg.optimizer)
    tstep = make_train_step(tm, opt, TrainConfig(**kw))
    jstate = jax_make_optimizer(jm.cfg.optimizer).init(jp)
    tstate = opt.init(tp)
    losses = []
    for s in range(steps):
        batch = jax_make_pipeline(tm.cfg, 16, 4, seed=s).batch(s)
        jp, jstate, jm_ = jstep(jp, jstate, jnp.asarray(s),
                                {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, tm_ = tstep(tp, tstate, s,
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
        losses.append((float(jm_["loss"]), float(tm_["loss"]),
                       float(jm_["grad_norm"]), float(tm_["grad_norm"]),
                       float(jm_["lr"]), tm_["lr"]))
    return jp, tp, losses


def _check_trained(jp, tp, losses):
    for jl, tl, jg, tg, jlr, tlr in losses:
        assert abs(jl - tl) <= LOSS_FP32_TOL * abs(jl)
        assert abs(jg - tg) <= 1e-4 * abs(jg)
        assert abs(jlr - tlr) <= 1e-6 * max(abs(jlr), 1e-12)
    assert losses[0][4] == 0.0                   # step 0 moves nothing
    for name, t, want in _pairs(tp, jp):
        tol = NORM_TOL if name.endswith(("scale", "bias", "q_norm",
                                         "k_norm")) else PARAM_TOL
        err = float(np.abs(t.numpy() - want).max())
        assert err <= tol, (name, err)


def test_train_steps_match_reference_adamw():
    jp, tp, losses = _train_both("minitron-4b")
    _check_trained(jp, tp, losses)
    # the stacked per-layer norm scales were decayed, the final norm's not
    ln1 = tp["decoder"]["layers"][0]["ln1"]["scale"]
    assert float(ln1.max()) < 1.0 - 1e-5 or float(ln1.min()) < 1.0 - 1e-5


def test_train_steps_match_reference_adafactor():
    jp, tp, losses = _train_both("qwen1.5-110b", optimizer="adafactor")
    _check_trained(jp, tp, losses)


def test_microbatches_match_reference():
    jp, tp, losses = _train_both("minitron-4b", steps=2, microbatches=2)
    _check_trained(jp, tp, losses)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium"])
def test_untrained_families_raise(arch):
    tm = Model(TC.get_reduced(arch), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.loss({}, {"tokens": torch.zeros((1, 4), dtype=torch.int32),
                     "labels": torch.zeros((1, 4), dtype=torch.int32)})
