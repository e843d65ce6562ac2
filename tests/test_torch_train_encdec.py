"""The port's enc-dec training against the reference's, on seamless-reduced
with the JAX init's fp32 weights carried over by
``params_from_jax(..., dtype=float32)`` (the training masters) and inputs
from numpy seeds.

- ``Model.loss`` and every gradient leaf (the encoder's, ``frame_norm``'s
  and the decoder's cross layers' included) against ``jax.value_and_grad``
  of the reference's ``Model.loss`` in fp32, with remat on and off, with
  frames from ``batch_with_frames`` (S_src = S) and with frames of other
  lengths (S 24 with S_src 40 and 16): loss within 1e-5 relative, each
  leaf within 1e-4 of its largest magnitude.
- Three steps of the port's ``Trainer.fit`` against the reference's
  ``Trainer.fit`` from the same weights (AdamW, lr 1e-3, warmup 1): the
  logged losses within 1e-5 relative, parameters within 1e-5 after the
  steps, the norm scales within 1e-6.
- Two microbatches slice the frames with the tokens; the step reports
  the reference's metrics (xent its loss, aux 0).
- The launcher trains ``seamless-m4t-medium --reduced`` on the CPU.
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
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import make_optimizer, tree_leaves  # noqa: E402
from repro_torch.train import (TrainConfig, Trainer,  # noqa: E402
                               make_train_step)

ARCH = "seamless-m4t-medium"
LOSS_FP32_TOL = 1e-5
GRAD_FP32_TOL = 1e-4
PARAM_TOL = 1e-5
NORM_TOL = 1e-6


def _pair(**over):
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype="float32", **over)
    tcfg = dataclasses.replace(TC.get_reduced(ARCH), dtype="float32", **over)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, strip(jm.init(jax.random.key(11))))
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jp, tcfg, "cpu", dtype=torch.float32)
    return jm, jax.tree.map(jnp.asarray, jp), tm, tp


def _batch(cfg, B=2, S=24, S_src=None, step=0):
    """SyntheticLM tokens with ``batch_with_frames``'s frames (S_src = S),
    or frames of ``S_src`` from a numpy seed; a few labels masked."""
    pipe = jax_make_pipeline(cfg, S, B, seed=3)
    b = pipe.batch_with_frames(step, cfg.d_model)
    if S_src is not None:
        rng = np.random.default_rng(S_src)
        b["frames"] = rng.standard_normal(
            (B, S_src, cfg.d_model)).astype(np.float32)
    b["labels"][0, -3:] = -1
    return b


def _pairs(tp, jtree):
    """(name, port tensor, reference array) for every port leaf; a layer's
    leaf of the decoder or the encoder against its slice of the
    reference's stacked leaf."""
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
        if key in ("decoder", "encoder"):
            assert not t.get("prologue")
            for i, lp in enumerate(t["layers"]):
                walk(lp, j["scanned"], (key, "layers", i), i)
            for k in t:
                if k not in ("layers", "prologue"):
                    walk(t[k], j[k], (key, k))
        else:
            walk(t, j, (key,))
    return out


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-8)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("S_src", [None, 40, 16],
                         ids=["frames_of_S", "S_src40", "S_src16"])
def test_loss_and_grads_match_reference_fp32(S_src, remat):
    jm, jp, tm, tp = _pair(remat=remat)
    batch = _batch(tm.cfg, S_src=S_src)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tm.loss(tp, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_FP32_TOL * abs(
        float(jloss))
    assert abs(metrics["xent"].item() - float(jmet["xent"])) <= \
        LOSS_FP32_TOL * abs(float(jmet["xent"]))
    assert metrics["aux"].item() == 0.0
    pairs = _pairs(tp, jgrads)
    assert len(pairs) == len(leaves)
    names = [name for name, _, _ in pairs]
    assert any(n.startswith("encoder.layers.1") for n in names)
    assert any(".cross." in n for n in names) and "frame_norm.scale" in names
    for name, t, want in pairs:
        _close(t.grad.numpy(), want, GRAD_FP32_TOL, name)


def test_encoder_gradient_flows_through_cross_attention():
    """Every encoder leaf gets a nonzero gradient under remat: the encoder
    output reaches the loss only through the checkpointed decoder layers'
    cross K/V."""
    _, _, tm, tp = _pair(remat=True)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss, _ = tm.loss(tp, {k: torch.as_tensor(v)
                           for k, v in _batch(tm.cfg, S_src=40).items()})
    loss.backward()
    for p in tree_leaves(tp["encoder"]) + [tp["frame_norm"]["scale"]]:
        assert p.grad is not None and float(p.grad.abs().max()) > 0.0


def test_trainer_fit_matches_reference(tmp_path):
    """Three steps of each side's ``Trainer.fit`` from the same weights,
    frames from its own pipeline's ``batch_with_frames``."""
    jm, jp, tm, tp = _pair()
    kw = dict(steps=3, lr=1e-3, warmup=1, log_every=1)
    pipe_kw = dict(seq_len=16, global_batch=4, seed=2)
    jtr = JaxTrainer(jm, JaxTrainConfig(ckpt_dir=str(tmp_path / "jax"), **kw),
                     None, pipeline=jax_make_pipeline(jm.cfg, **pipe_kw))
    jtr.init_state()                      # builds its jitted step
    jout = jtr.fit(params=jp, opt_state=jtr.opt.init(jp))
    ttr = Trainer(tm, TrainConfig(ckpt_dir=str(tmp_path / "torch"), **kw),
                  pipeline=make_pipeline(tm.cfg, **pipe_kw), device="cpu")
    tout = ttr.fit(params=tp, opt_state=ttr.opt.init(tp))
    assert jout["step"] == tout["step"] == 3
    assert [m["step"] for m in tout["metrics"]] == [0, 1, 2]
    for jmet, tmet in zip(jout["metrics"], tout["metrics"], strict=True):
        for key in ("loss", "xent", "grad_norm"):
            assert abs(tmet[key] - jmet[key]) <= LOSS_FP32_TOL * abs(
                jmet[key]), (key, tmet, jmet)
    assert tout["metrics"][-1]["loss"] < tout["metrics"][0]["loss"]
    for name, t, want in _pairs(tout["params"], jout["params"]):
        tol = NORM_TOL if name.endswith(("scale", "bias")) else PARAM_TOL
        err = float(np.abs(t.numpy() - want).max())
        assert err <= tol, (name, err)


def test_microbatches_split_the_frames():
    """Two microbatches slice the frames with the tokens: the step's loss
    is the mean of each half's loss, its metrics the reference's."""
    _, _, tm, tp = _pair()
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(tm.cfg, B=4, S_src=40).items()}
    with torch.no_grad():
        halves = [tm.loss(tp, {k: v[i:i + 2] for k, v in batch.items()})[0]
                  for i in (0, 2)]
    opt = make_optimizer("adamw")
    step = make_train_step(tm, opt, TrainConfig(microbatches=2))
    _, _, m = step(tp, opt.init(tp), 0, batch)
    want = float(halves[0] + halves[1]) / 2
    assert abs(float(m["loss"]) - want) <= 1e-6 * abs(want)
    assert float(m["xent"]) == float(m["loss"]) and float(m["aux"]) == 0.0


def test_launcher_trains_encdec_on_cpu(tmp_path, capsys):
    rc = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "3",
                            "--seq-len", "16", "--global-batch", "4",
                            "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ck")])
    assert rc == 0
    assert '"status": "completed"' in capsys.readouterr().out
