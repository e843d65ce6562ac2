"""The port's MoE and MLA training against the reference's, on
deepseek-v2-lite-reduced (MLA, a dense prologue layer, shared experts)
and arctic-reduced (GQA, top-2 experts beside a dense residual FFN), with
the JAX init's fp32 weights carried over by ``params_from_jax(...,
dtype=float32)`` (the training masters).

- ``Model.loss`` (the cross-entropy plus 0.01 times the MoE layers'
  load-balance loss) and its gradients against ``jax.value_and_grad`` of
  the reference's ``Model.loss``, with the einsum and the gather dispatch.
  fp32: loss, xent and aux within 1e-5 relative, each gradient leaf
  within 1e-4 of its largest magnitude (the prologue's leaves against the
  reference's unstacked prologue, the layers' against their slices of its
  stacked leaves); bf16 activations: loss within 2e-2 relative.
- Three steps of ``make_train_step`` against the reference's (lr 1e-3,
  warmup 1, fp32): AdamW on both configs (their reduced configs' optimizer)
  and Adafactor on arctic-reduced (its full config's): parameters within
  1e-5, norm scales within 1e-6, so that a decay rule that marked a leaf
  otherwise than the reference's would show.
- The plain flash backward at MLA's shapes (q and k at head dim 192, v
  zero-padded from 128) against ``jax.vjp`` of the reference's
  ``blockwise_attention``, fp32 within 1e-5.
- The train step reports the model's aux; with microbatches it reports
  the reference's metrics (xent the step's loss, aux 0).  The launcher
  trains both configs on the CPU.
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
from repro.models import layers as JL  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import make_optimizer, tree_leaves  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402

LOSS_FP32_TOL = 1e-5
GRAD_FP32_TOL = 1e-4
LOSS_BF16_TOL = 2e-2
PARAM_TOL = 1e-5
NORM_TOL = 1e-6
ATTN_FP32_TOL = 1e-5
MOE = ("deepseek-v2-lite-16b", "arctic-480b")
DISPATCH = ("einsum", "gather")


def _pair(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=dtype, **over)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=dtype, **over)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, strip(jm.init(jax.random.key(7))))
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jp, tcfg, "cpu", dtype=torch.float32)
    return jm, jax.tree.map(jnp.asarray, jp), tm, tp


def _batch(cfg, B=2, S=24, step=0):
    b = jax_make_pipeline(cfg, S, B, seed=3).batch(step)
    b["labels"][0, -3:] = -1                   # masked positions
    return b


def _pairs(tp, jtree):
    """(name, port tensor, reference array) for every port leaf: the
    decoder's prologue against the reference's unstacked prologue, each
    scanned layer's leaf against its slice of the stacked leaf."""
    out = []

    def walk(t, j, path, layer=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, j[k], path + (k,), layer)
        else:
            arr = np.asarray(j, np.float32)
            out.append((".".join(map(str, path)), t,
                        arr if layer is None else arr[layer]))

    for key, t in tp.items():
        j = jtree[key]
        if key == "decoder":
            for i, lp in enumerate(t["prologue"]):
                walk(lp, j["prologue"][i], ("decoder", "prologue", i))
            for i, lp in enumerate(t["layers"]):
                walk(lp, j["scanned"], ("decoder", "layers", i), i)
        else:
            walk(t, j, (key,))
    return out


def _port_grads(tm, tp, batch, moe_dispatch="einsum"):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = tm.loss(tp, tb, moe_dispatch=moe_dispatch)
    loss.backward()
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference_fp32(arch, dispatch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, moe_dispatch=dispatch), has_aux=True))(jp)
    loss, metrics = _port_grads(tm, tp, batch, dispatch)
    assert float(jmet["aux"]) > 0.0           # the aux loss is in play
    assert _rel(loss.item(), float(jloss)) <= LOSS_FP32_TOL
    for name in ("xent", "aux"):
        assert _rel(metrics[name].item(), float(jmet[name])) <= \
            LOSS_FP32_TOL, name
    seen = 0
    for name, t, want in _pairs(tp, jgrads):
        got = t.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-8)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_FP32_TOL * scale, (name, err, scale)
        seen += 1
    assert seen == len(tree_leaves(tp))
    router = tp["decoder"]["layers"][0]["moe"]["router"]
    assert float(router.grad.abs().max()) > 0.0


@pytest.mark.parametrize("arch", MOE)
def test_loss_matches_reference_bf16(arch):
    jm, jp, tm, tp = _pair(arch, dtype="bfloat16")
    batch = _batch(tm.cfg)
    jloss, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    loss, _ = _port_grads(tm, tp, batch)
    assert _rel(loss.item(), float(jloss)) <= LOSS_BF16_TOL
    assert all(t.grad is not None and t.grad.isfinite().all()
               for t in tree_leaves(tp))


def _train_both(arch, steps=3, **over):
    jm, jp, tm, tp = _pair(arch, **over)
    kw = dict(steps=10, lr=1e-3, warmup=1)
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
                       float(jm_["aux"]), float(tm_["aux"])))
    return jp, tp, losses


@pytest.mark.parametrize("arch,optimizer", [
    ("deepseek-v2-lite-16b", "adamw"), ("arctic-480b", "adamw"),
    ("arctic-480b", "adafactor")])
def test_train_steps_match_reference(arch, optimizer):
    jp, tp, losses = _train_both(arch, optimizer=optimizer)
    for jl, tl, jg, tg, ja, ta in losses:
        assert _rel(tl, jl) <= LOSS_FP32_TOL
        assert _rel(tg, jg) <= 1e-4
        assert ja > 0.0 and _rel(ta, ja) <= LOSS_FP32_TOL
    for name, t, want in _pairs(tp, jp):
        tol = NORM_TOL if name.endswith(("scale", "bias", "kv_norm")) \
            else PARAM_TOL
        err = float(np.abs(t.numpy() - want).max())
        assert err <= tol, (name, err)


def test_train_step_reports_the_aux_loss():
    """The step's metrics carry the model's aux (not zeros) without
    microbatches; with them they are the reference's: xent the step's
    loss (the microbatches' mean loss) and aux 0."""
    _, _, tm, tp = _pair("deepseek-v2-lite-16b")
    batch = {k: torch.as_tensor(v) for k, v in _batch(tm.cfg, B=4).items()}
    with torch.no_grad():
        _, whole = tm.loss(tp, batch)
        halves = [tm.loss(tp, {k: v[i:i + 2] for k, v in batch.items()})[0]
                  for i in (0, 2)]
    opt = make_optimizer("adamw")
    for n_mb in (1, 2):
        step = make_train_step(tm, opt, TrainConfig(microbatches=n_mb))
        snapshot = [t.clone() for t in tree_leaves(tp)]
        _, _, m = step(tp, opt.init(tp), 0, batch)
        if n_mb == 1:
            want = float(whole["aux"])
            assert float(m["aux"]) > 0.0
            assert abs(float(m["aux"]) - want) <= 1e-6 * want
        else:
            want = float(halves[0] + halves[1]) / 2
            assert abs(float(m["loss"]) - want) <= 1e-6 * abs(want)
            assert float(m["xent"]) == float(m["loss"])
            assert float(m["aux"]) == 0.0
        for t, s in zip(tree_leaves(tp), snapshot):   # lr 0 at step 0
            assert torch.equal(t, s)


@pytest.mark.parametrize("B,S,H", [(2, 40, 4), (1, 70, 2)])
def test_plain_flash_backward_at_mla_head_dims(B, S, H):
    """q and k at head dim 192 (128 nope + 64 rope), v zero-padded from 128
    as MLA pads it: out and (dq, dk, dv) of the plain Function against
    ``jax.vjp`` of the reference's ``blockwise_attention``; the padded
    columns' dv is zero on both sides when their output gradient is."""
    rng = np.random.default_rng(B * S + H)
    q, k = (rng.normal(size=(B, S, H, 192)).astype(np.float32)
            for _ in range(2))
    v = np.pad(rng.normal(size=(B, S, H, 128)).astype(np.float32),
               ((0, 0), (0, 0), (0, 0), (0, 64)))
    g = np.pad(rng.normal(size=(B, S, H, 128)).astype(np.float32),
               ((0, 0), (0, 0), (0, 0), (0, 64)))
    kw = dict(causal=True, block_size=32)
    out, vjp = jax.vjp(lambda a, b, c: JL.blockwise_attention(a, b, c, **kw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(t) for t in (out,) + vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.tensor(a).requires_grad_(True) for a in (q, k, v))
    o = L.blockwise_attention(tq, tk, tv, **kw)
    o.backward(torch.tensor(g))
    got = [t.detach().numpy() for t in (o, tq.grad, tk.grad, tv.grad)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a - b).max()) <= ATTN_FP32_TOL * scale, name
    assert float(np.abs(got[3][..., 128:]).max()) == 0.0


@pytest.mark.parametrize("arch", MOE)
def test_launcher_trains_moe_on_cpu(tmp_path, arch):
    seen = []
    rc = launch_train.main(["--arch", arch, "--reduced", "--steps", "3",
                            "--seq-len", "16", "--global-batch", "2",
                            "--ckpt-dir", str(tmp_path / "ck"), "--device",
                            "cpu"], on_step=lambda s, m: seen.append(m))
    assert rc == 0
    assert [m["step"] for m in seen] == [0, 1, 2]
    assert all(m["aux"] > 0.0 and np.isfinite(m["loss"]) for m in seen)
