"""The port's training substrate against the reference's: optimizers,
clipping and the schedule on random trees, the data pipeline, checkpoints,
the fault machinery, the trainer's preemption and resume, and the launcher
(copies of the cases in ``test_substrate.py``, plus parity).

The optimizer trees hold a decoder stack as the port does (a list of
per-layer dicts under ``layers``) and as the reference does (one stacked
leaf per path under ``scanned``), with the same numbers; after a few
updates with the same random gradients every leaf agrees within 1e-6.
"""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jopt  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, make_pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import fault  # noqa: E402

L, D, F = 3, 8, 6


def _trees(rng):
    """(port tree, reference tree) of the same numbers."""
    stacked = {"w": rng.normal(size=(L, D, F)), "ln": {"scale": 1 + 0.1 *
               rng.normal(size=(L, D))}, "h": rng.normal(size=(L, D, 2, 4))}
    top = {"embed": rng.normal(size=(16, D)),
           "final_norm": {"scale": 1 + 0.1 * rng.normal(size=(D,))}}
    f32 = lambda a: np.asarray(a, np.float32)
    ref = {**{k: jax.tree.map(f32, v) for k, v in top.items()},
           "decoder": {"scanned": jax.tree.map(f32, stacked)}}
    layers = [jax.tree.map(lambda a: torch.tensor(f32(a[i])), stacked)
              for i in range(L)]
    port = {**jax.tree.map(lambda a: torch.tensor(f32(a)), top),
            "decoder": {"prologue": [], "layers": layers}}
    return port, ref


def _assert_trees(port, ref, tol):
    for key in ("embed", "final_norm"):
        for a, b in zip(topt.tree_leaves(port[key]), jax.tree.leaves(ref[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                       rtol=0)
    for i, layer in enumerate(port["decoder"]["layers"]):
        for a, b in zip(topt.tree_leaves(layer),
                        jax.tree.leaves(ref["decoder"]["scanned"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b)[i], atol=tol,
                                       rtol=0)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    rng = np.random.default_rng(0)
    tp, jp = _trees(rng)
    jp = jax.tree.map(jnp.asarray, jp)
    kw = {"weight_decay": 0.5} if name == "adafactor" else {}
    jo, to = jopt.make_optimizer(name, **kw), topt.make_optimizer(name, **kw)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        gp, gj = _trees(np.random.default_rng(10 + step))
        jp, js = jo.update(jax.tree.map(jnp.asarray, gj), js, jp, 1e-2)
        tp, ts = to.update(gp, ts, tp, 1e-2)
    _assert_trees(tp, jax.tree.map(np.asarray, jp), 1e-6)
    if name == "adamw":
        # a stacked per-layer scale decays, the final norm's does not
        ones_p, ones_j = _trees(np.random.default_rng(1))
        for t in topt.tree_leaves(ones_p):
            t.fill_(1.0)
        zeros = topt.tree_map(torch.zeros_like, ones_p)
        tp1, _ = to.update(zeros, to.init(ones_p), ones_p, 1e-2)
        assert float(tp1["decoder"]["layers"][0]["ln"]["scale"][0]) == \
            pytest.approx(0.999, abs=1e-7)
        assert float(tp1["final_norm"]["scale"][0]) == 1.0


def test_adafactor_state_is_the_stacked_factoring():
    tp, _ = _trees(np.random.default_rng(0))
    v = topt.adafactor().init(tp)["v"]
    assert v["decoder.layers.ln.scale"]["vr"].shape == (L,)
    assert v["decoder.layers.ln.scale"]["vc"].shape == (D,)
    assert v["decoder.layers.w"]["vr"].shape == (L, D)
    assert v["final_norm.scale"]["v"].shape == (D,)
    assert v["embed"]["vr"].shape == (16,)


def test_clip_and_schedule_match_reference():
    tp, jp = _trees(np.random.default_rng(4))
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, jp), 1.0)
    tc, tn = topt.clip_by_global_norm(tp, 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    _assert_trees(tc, jax.tree.map(np.asarray, jc), 1e-7)
    _, tn2 = topt.clip_by_global_norm(tc, 1.0)
    assert float(tn2) <= 1.0 + 1e-5
    jl, tl = jopt.cosine_schedule(1e-3, 10, 100), topt.cosine_schedule(
        1e-3, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert tl(s) == pytest.approx(float(jl(jnp.asarray(s))), rel=1e-6,
                                      abs=1e-12)
    assert tl(0) == 0.0


@pytest.mark.parametrize("make_opt", [topt.adamw, topt.adafactor])
def test_optimizers_converge(make_opt):
    opt = make_opt()
    params = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    state = opt.init(params)

    def loss(p):
        return torch.sum(torch.square(p["w"] - 3.0)) + torch.sum(
            torch.square(p["b"] + 1.0))

    loss0 = float(loss(params))
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - 3.0), "b": 2 * (params["b"] + 1.0)}
        params, state = opt.update(grads, state, params, 5e-2)
    assert float(loss(params)) < loss0 * 0.05


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2])
def test_pipeline_batches_bitwise_reference(hosts):
    for h in range(hosts):
        tcfg = DataConfig(vocab_size=1000, seq_len=33, global_batch=4, seed=7)
        jcfg = JaxDataConfig(vocab_size=1000, seq_len=33, global_batch=4,
                             seed=7)
        tb = SyntheticLM(tcfg, host_id=h, num_hosts=hosts)
        jb = JaxSyntheticLM(jcfg, host_id=h, num_hosts=hosts)
        for step in (0, 5):
            a, b = tb.batch(step), jb.batch(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(
                tb.batch_with_frames(step, 8)["frames"],
                jb.batch_with_frames(step, 8)["frames"])


def test_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=4, seed=7)
    p1, p2 = SyntheticLM(cfg), SyntheticLM(cfg)
    b5a = p1.batch(5)
    for s in (0, 3):
        p2.batch(s)
    np.testing.assert_array_equal(b5a["tokens"], p2.batch(5)["tokens"])
    assert b5a["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(b5a["labels"][:, :-1], b5a["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# checkpoints and faults
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_latest():
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1, 2, 3])},
            "layers": [{"w": torch.randn(2, 2).to(torch.bfloat16)},
                       {"w": torch.randn(2, 2).to(torch.bfloat16)}]}
    like = topt.tree_map(torch.zeros_like, tree)
    with tempfile.TemporaryDirectory() as d:
        assert ck.latest_step(d) is None
        ck.save(d, 3, tree, extra={"next_step": 3})
        ck.save(d, 7, tree, extra={"next_step": 7})
        assert ck.latest_step(d) == 7
        got, extra = ck.restore(d, 7, like)
        assert extra["next_step"] == 7 and got is like
        for a, b in zip(topt.tree_leaves(tree), topt.tree_leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        manifest = json.load(open(os.path.join(d, "step_00000007",
                                               "manifest.json")))
        assert manifest["leaves"]["layers/1/w"]["dtype"] == "bfloat16"


def test_checkpoint_atomicity_ignores_partial():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, {"a": torch.zeros(3)})
        os.makedirs(os.path.join(d, "step_00000005"))   # no manifest: partial
        assert ck.latest_step(d) == 1


def test_straggler_watchdog_flags_runs_not_blips():
    wd = fault.StragglerWatchdog(threshold=2.0, patience=3, warmup=4)
    assert {wd.observe(i, 1.0) for i in range(8)} == {fault.ACTION_NONE}
    assert wd.observe(8, 5.0) == fault.ACTION_WARN
    assert wd.observe(9, 1.0) == fault.ACTION_NONE
    a = [wd.observe(10 + i, 5.0) for i in range(3)]
    assert a[-1] == fault.ACTION_CHECKPOINT_AND_RESHARD


def test_preemption_flag_file(tmp_path):
    flag = tmp_path / "preempt"
    g = fault.PreemptionGuard(flag_file=str(flag), install_signal=False)
    assert not g.check()
    flag.write_text("now")
    assert g.check()


def test_restart_policy_backoff():
    p = fault.RestartPolicy(max_restarts=3, base_backoff_s=1.0,
                            max_backoff_s=3.0)
    assert [p.next_backoff() for _ in range(4)] == [1.0, 2.0, 3.0, None]


# ---------------------------------------------------------------------------
# trainer and launcher
# ---------------------------------------------------------------------------

def test_trainer_preemption_checkpoints_and_resumes(tmp_path):
    cfg = get_reduced("minitron-4b")
    model = build_model(cfg, "cpu")
    pipe = make_pipeline(cfg, seq_len=16, global_batch=2)
    tc = TrainConfig(steps=6, lr=1e-3, warmup=1, checkpoint_every=100,
                     ckpt_dir=str(tmp_path / "a"), log_every=1)
    seen = {}
    tr = Trainer(model, tc, pipeline=pipe, device="cpu",
                 on_step=lambda s, m: seen.setdefault(s, m["loss"]))
    counter = {"n": 0}

    def fake_check():
        counter["n"] += 1
        return counter["n"] > 3

    tr.guard.check = fake_check
    out = tr.fit()
    assert out["status"] == "preempted"
    assert ck.latest_step(tc.ckpt_dir) == out["step"] == 4
    out2 = Trainer(model, tc, pipeline=pipe, device="cpu",
                   on_step=lambda s, m: seen.setdefault(s, m["loss"])).fit()
    assert out2["status"] == "completed" and out2["step"] == 6
    # the resumed run's losses are an uninterrupted run's
    whole = {}
    tc2 = TrainConfig(steps=6, lr=1e-3, warmup=1, checkpoint_every=100,
                      ckpt_dir=str(tmp_path / "b"), log_every=1)
    Trainer(model, tc2, pipeline=pipe, device="cpu",
            on_step=lambda s, m: whole.setdefault(s, m["loss"])).fit()
    assert sorted(seen) == sorted(whole) == list(range(6))
    for s in range(6):
        assert seen[s] == pytest.approx(whole[s], rel=1e-6)


def test_trainer_checkpoint_every_zero(tmp_path):
    """checkpoint_every 0: no periodic or final checkpoint, but a
    preemption still writes one."""
    cfg = get_reduced("minitron-4b")
    model = build_model(cfg, "cpu")
    pipe = make_pipeline(cfg, seq_len=16, global_batch=2)
    tc = TrainConfig(steps=3, lr=1e-3, warmup=1, checkpoint_every=0,
                     ckpt_dir=str(tmp_path / "a"))
    out = Trainer(model, tc, pipeline=pipe, device="cpu").fit()
    assert out["status"] == "completed" and out["step"] == 3
    assert ck.latest_step(tc.ckpt_dir) is None
    tr = Trainer(model, tc, pipeline=pipe, device="cpu")
    tr.guard.check = lambda: True
    out = tr.fit()
    assert out["status"] == "preempted"
    assert ck.latest_step(tc.ckpt_dir) == out["step"] == 1


def test_trainer_device_rules():
    model = build_model(get_reduced("minitron-4b"), "cpu")
    with pytest.raises(ValueError):
        Trainer(model, TrainConfig(), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Trainer(model, TrainConfig())


def test_launcher_trains_on_cpu(tmp_path, capsys):
    flag = tmp_path / "preempt"
    steps = []

    def on_step(step, metrics):
        steps.append(step)
        if step == 1 and len(steps) == 2:
            flag.write_text("now")

    rc = launch_train.main(["--arch", "minitron-4b", "--reduced", "--steps",
                            "4", "--seq-len", "16", "--global-batch", "2",
                            "--ckpt-dir", str(tmp_path / "ck"), "--device",
                            "cpu", "--preempt-file", str(flag)],
                           on_step=on_step)
    assert rc == 0
    assert steps == [0, 1, 2, 3]          # preempted after 1, resumed at 2
    assert not flag.exists()
    out = capsys.readouterr().out
    assert '"status": "preempted"' in out and '"status": "completed"' in out
    # outside torchrun the production mesh has no process group: exit 2
    assert launch_train.main(["--arch", "minitron-4b", "--reduced",
                              "--production-mesh", "--device", "cpu"]) == 2
    assert "torchrun" in capsys.readouterr().err
