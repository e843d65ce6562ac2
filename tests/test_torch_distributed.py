"""The port's multi-device training layer against the reference's, on the
CPU: the reference's counterparts of ``tests/test_distributed.py`` run in
one subprocess on 8 fake JAX devices (its meshes built here with
``AxisType.Auto``, which the installed JAX needs for a ``jit`` under a
mesh), and the port's in one gloo world of 8 CPU ranks
(``tests/_torch_dist_worker.py``: one thread per rank, a ``file://``
rendezvous of its own, so that test workers do not collide).  Each side
runs once per module.

- The sharded step: qwen2.5-reduced on a (2 data, 4 model) mesh with
  ``train_rules(sequence_parallel=False)`` and ``True``, two steps (the
  schedule's lr is 0 at step 0: one step would compare parameters that
  did not move), from the reference's initial parameters and batches.  In
  fp32 the loss is within 1e-5 relative and every parameter within 1e-5
  of both the reference's sharded step and the port's single-device step;
  in bf16 within the reference test's own 5e-2.
- ``Trainer.fit`` on the mesh from ``setup_sharded_state`` (the port's
  seeded init, each rank's pipeline giving its batch rows) against
  ``Trainer.fit`` on one device: losses 1e-5, parameters 1e-5.
- The elastic reshard: a (2, 4) checkpoint restored onto (4, 2) with
  transposed placements, and onto one device, bit for bit.
- ``compressed_psum`` and two rounds of ``ErrorFeedback`` on an 8-wide pod
  mesh: bitwise the reference's, and the psum within 2 scale of the mean.
- The attention kernels' local-shard call (each model rank passes the
  kernel the KV heads of its query heads) against the unsharded call.
- The mesh builders at the production shapes (256 and 512 ranks) on
  torch's fake process group, and the launcher's exit on a world size
  that does not match its mesh.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LOSS_FP32_TOL = 1e-5
PARAM_FP32_TOL = 1e-5
BF16_TOL = 5e-2              # the reference test's own

_REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_reduced
from repro.data import make_pipeline
from repro.distribution import partitioning as part
from repro.models import build_model
from repro.optim import ErrorFeedback, compressed_psum, make_optimizer
from repro.train.trainer import (TrainConfig, make_train_step,
                                 setup_sharded_state)

def mesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))

out = {}
for dt in ("float32", "bfloat16"):
    cfg = dataclasses.replace(get_reduced("qwen2.5-32b"), dtype=dt)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer)
    tc = TrainConfig(steps=4, lr=1e-3, warmup=1)
    out["batches"] = [make_pipeline(cfg, 16, 4, seed=s).batch(s)
                      for s in range(2)]
    out["params0"] = jax.tree.map(
        np.asarray, part.strip(model.init(jax.random.key(0))))
    for sp in (False, True):
        msh = mesh((2, 4), ("data", "model"))
        rules = part.train_rules(sequence_parallel=sp)
        # the rules' residual spec names "pod", which this mesh lacks
        res = (part.sanitize_spec(rules.spec(("batch", "act_seq", None)),
                                  msh) if sp else None)
        p, o, _, _ = setup_sharded_state(model, opt, msh, rules,
                                         jax.random.key(0))
        step = jax.jit(make_train_step(model, opt, tc, residual_spec=res))
        losses = []
        with msh:
            for s, b in enumerate(out["batches"]):
                p, o, m = step(p, o, jnp.asarray(s),
                               {k: jnp.asarray(v) for k, v in b.items()})
                losses.append(float(m["loss"]))
        out[(dt, sp)] = (losses, jax.tree.map(np.asarray, p))

msh = mesh((8,), ("pod",))
x = np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32)

@partial(jax.shard_map, mesh=msh, in_specs=P("pod"), out_specs=P("pod"))
def reduce_compressed(xs):
    return compressed_psum(xs[0], "pod")[None]

out["psum_x"] = x
out["psum"] = np.asarray(reduce_compressed(x))
g = {"a": np.random.default_rng(2).normal(size=(8, 64)).astype(np.float32),
     "b": np.random.default_rng(3).normal(size=(8, 3, 5)).astype(np.float32)}

@partial(jax.shard_map, mesh=msh, in_specs=(P("pod"), P("pod")),
         out_specs=(P("pod"), P("pod")))
def feedback(gs, es):
    a, e = ErrorFeedback.apply(jax.tree.map(lambda t: t[0], gs),
                               jax.tree.map(lambda t: t[0], es), "pod")
    return (jax.tree.map(lambda t: t[None], a),
            jax.tree.map(lambda t: t[None], e))

e = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16), g)
out["ef_g"], out["ef"] = g, []
for it in range(2):
    a, e = feedback(jax.tree.map(lambda t: t * (1 + it), g), e)
    out["ef"].append((jax.tree.map(np.asarray, a), jax.tree.map(
        lambda t: np.asarray(t.astype(jnp.float32)), e)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): each side's results, one run each."""
    d = tmp_path_factory.mktemp("dist")
    ref_path, port_path = d / "ref.pkl", d / "port.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(ref_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    out = subprocess.run([sys.executable,
                          str(ROOT / "tests" / "_torch_dist_worker.py"),
                          str(ref_path), str(port_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(port_path, "rb") as f:
        port = pickle.load(f)
    return ref, port


def _pairs(tp, jtree):
    """(name, port array, reference array) for every port leaf; a decoder
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
        if key == "decoder":
            walk(t["layers"], jtree[key]["scanned"], ("decoder", "layers"))
        else:
            walk(t, jtree[key], (key,))
    return out


def _leaves(tree):
    """Leaves in key order (a sharded tree keeps its spec tree's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close(got, want, tol, rel):
    for g, w in zip(got, want):
        assert abs(g - w) <= tol * (abs(w) if rel else 1.0), (got, want)


@pytest.mark.parametrize("sp", [False, True], ids=["dp_tp", "seq_par"])
def test_sharded_step_fp32_matches_reference_and_single_device(runs, sp):
    ref, port = runs
    losses, params = port[("float32", sp)]
    ref_losses, ref_params = ref[("float32", sp)]
    _close(losses, ref_losses, LOSS_FP32_TOL, rel=True)
    for name, got, want in _pairs(params, ref_params):
        assert np.abs(got - want).max() <= PARAM_FP32_TOL, name
    one_losses, one = port[("float32", "single")]
    _close(losses, one_losses, LOSS_FP32_TOL, rel=True)
    for got, want in zip(_leaves(params), _leaves(one)):
        assert np.abs(got - want).max() <= PARAM_FP32_TOL
    assert losses[0] != losses[1]            # the second step moved


@pytest.mark.parametrize("sp", [False, True], ids=["dp_tp", "seq_par"])
def test_sharded_step_bf16_within_reference_tolerance(runs, sp):
    ref, port = runs
    losses, params = port[("bfloat16", sp)]
    ref_losses, ref_params = ref[("bfloat16", sp)]
    _close(losses, ref_losses, BF16_TOL, rel=False)
    for name, got, want in _pairs(params, ref_params):
        assert np.abs(got - want).max() <= BF16_TOL, name
    one_losses, one = port[("bfloat16", "single")]
    _close(losses, one_losses, BF16_TOL, rel=False)
    for got, want in zip(_leaves(params), _leaves(one)):
        assert np.abs(got - want).max() <= BF16_TOL


def test_trainer_fit_on_mesh_equals_one_device(runs):
    _, port = runs
    losses, params, (host_id, num_hosts) = port["fit_mesh"]
    one_losses, one = port["fit_single"]
    assert num_hosts == 2 and len(losses) == 3
    _close(losses, one_losses, LOSS_FP32_TOL, rel=True)
    for got, want in zip(_leaves(params), _leaves(one)):
        assert np.abs(got - want).max() <= PARAM_FP32_TOL


@pytest.mark.parametrize("target", ["mesh_4x2", "one_device"])
def test_elastic_checkpoint_reshard(runs, target):
    _, port = runs
    if target == "one_device":
        assert port["elastic_single"]
        return
    got = port["elastic_mesh"]
    assert got["w_equal"] and got["state_equal"]
    assert got["w_local"] == (4, 2)          # dim 0 over 2, dim 1 over 4
    assert got["saved_mesh"] == [2, 4]


def test_compressed_psum_matches_reference(runs):
    ref, port = runs
    assert np.array_equal(port["psum"], ref["psum"])
    x = ref["psum_x"]
    scale = float(np.abs(x).max()) / 127.0
    assert np.abs(port["psum"] - x.mean(0)).max() <= 2 * scale


def test_error_feedback_matches_reference(runs):
    ref, port = runs
    for (rg, re_), every in zip(ref["ef"], port["ef"]):
        for rank, (pg, pe) in enumerate(every):
            for k in rg:
                assert np.array_equal(pg[k], rg[k][rank]), (k, rank)
                assert np.array_equal(pe[k], re_[k][rank]), (k, rank)


@pytest.mark.parametrize("heads", [(4, 2), (8, 2), (8, 4), (16, 2), (8, 1),
                                   (6, 2)], ids=lambda h: f"{h[0]}on{h[1]}")
def test_attention_on_local_shards_equals_unsharded(runs, heads):
    _, port = runs
    assert port["local_heads"][heads] <= 1e-5


_MESHES = textwrap.dedent("""
    import sys
    sys.path.insert(0, "src")
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as M
    out = {}
    for world, multi in ((256, False), (512, True), (256, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=3,
                                world_size=world)
        try:
            m = M.make_production_mesh(multi_pod=multi, device="cpu")
            out[f"{world}-{multi}"] = [list(m.mesh.shape),
                                       list(m.mesh_dim_names)]
        except ValueError as e:
            out[f"{world}-{multi}"] = str(e)
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_mesh_builders_at_production_shapes():
    out = subprocess.run([sys.executable, "-c", "import json\n" + _MESHES],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["256-False"] == [[16, 16], ["data", "model"]]
    assert got["512-True"] == [[2, 16, 16], ["pod", "data", "model"]]
    assert "512" in got["256-True"] and "256" in got["256-True"]


def test_launcher_world_size_must_match_its_mesh():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "minitron-4b", "--reduced",
                          "--production-mesh", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2
    assert "256" in out.stderr and "1" in out.stderr, out.stderr
