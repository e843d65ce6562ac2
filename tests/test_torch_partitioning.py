"""The port's partitioning layer (``repro_torch.distribution``) against the
reference's (``repro.distribution.partitioning``), with no process group:

- every rules table (``train_rules`` under both flags, ``serve_rules``
  under both, ``single_device_rules``) equals the reference's entry for
  entry, and ``physical``/``spec`` agree over every logical axis;
- ``fit_spec``, ``sanitize_spec`` and ``validate_divisibility`` agree with
  the reference's over a parametrised set of shapes, specs and meshes
  (the reference's take any object with ``axis_names`` and
  ``devices.shape``, the port's a mapping of dim sizes);
- for every registered reduced config, ``Model.logical_specs()`` equals
  the reference's ``logical_specs(model.init(...))`` leaf for leaf,
  through the bridge's mapping (a scanned layer's leaf drops its leading
  "layers" axis), and the tree has the structure of ``Model.init``'s;
- ``placements`` of a physical spec, and ``ShardingPlan``;
- ``tp_submesh`` and ``replica_submesh`` as slices of a ``DeviceMesh``
  (torch's fake process group, in a subprocess).
"""
import itertools
import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import partitioning as jpart  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distribution import partitioning as part  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

RULES = [("train", {}), ("train", {"fsdp": False}),
         ("train", {"sequence_parallel": False}),
         ("serve", {}), ("serve", {"fsdp_weights": True}), ("single", {})]


def _rules(which, kw, mod):
    return {"train": mod.train_rules, "serve": mod.serve_rules,
            "single": mod.single_device_rules}[which](**kw)


@pytest.mark.parametrize("which,kw", RULES,
                         ids=[f"{w}-{k}" for w, k in RULES])
def test_rules_tables_equal_reference(which, kw):
    mine, ref = _rules(which, kw, part), _rules(which, kw, jpart)
    assert dict(mine.rules) == dict(ref.rules)
    names = sorted(ref.rules) + ["unknown"]
    for logical in names + [tuple(p) for p in
                            itertools.permutations(names[:4], 2)]:
        assert mine.physical(logical) == ref.physical(logical), logical
    spec = ("batch", "act_seq", None, ("heads", "mlp"))
    assert mine.spec(spec) == tuple(ref.spec(spec))


MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 2},
          {"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
          {"model": 8}, {"data": 1, "model": 1}]
SPECS = [(("pod", "data"), "model", None), ("model", None, "data"),
         (None, ("data", "model")), ("pod", "model"), ("data",),
         (("pod", "data"), None, "model")]
SHAPES = [(8, 16, 4), (2, 25, 64), (1, 256, 3), (32, 32, 32), (6, 4, 2)]


def _jax_mesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@pytest.mark.parametrize("mesh", MESHES,
                         ids=["x".join(map(str, m.values())) for m in MESHES])
def test_spec_fitting_agrees_with_reference(mesh):
    jm = _jax_mesh(mesh)
    for spec, shape in itertools.product(SPECS, SHAPES):
        assert part.sanitize_spec(spec, mesh) == tuple(
            jpart.sanitize_spec(P(*spec), jm)), spec
        got = part.fit_spec(spec, shape, mesh)
        assert got == tuple(jpart.fit_spec(P(*spec), shape, jm)), \
            (spec, shape)
        assert part.validate_divisibility(shape, got, mesh)
        clean = part.sanitize_spec(spec, mesh)
        assert part.validate_divisibility(shape, clean, mesh) == \
            jpart.validate_divisibility(shape, P(*clean), jm), (spec, shape)


def _reference_specs(arch):
    """The reference's logical specs in the port's structure."""
    jm = jax_build_model(jax_get_reduced(arch))
    specs = jpart.logical_specs(jax.eval_shape(jm.init, jax.random.key(0)))

    def unstack(t):
        if isinstance(t, dict):
            return {k: unstack(v) for k, v in t.items()}
        assert t[0] == "layers", t
        return tuple(t[1:])

    cfg = get_reduced(arch)
    dec = specs["decoder"]
    n_pro = len(dec.get("prologue", []))
    out = {k: v for k, v in specs.items() if k not in ("decoder", "encoder")}
    out["decoder"] = {"prologue": list(dec.get("prologue", [])),
                      "layers": [unstack(dec["scanned"])
                                 for _ in range(cfg.num_layers - n_pro)]}
    if "encoder" in specs:
        out["encoder"] = {"layers": [unstack(specs["encoder"]["scanned"])
                                     for _ in range(cfg.encoder_layers)],
                          "final_norm": specs["encoder"]["final_norm"]}
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_specs_equal_reference(arch):
    model = Model(get_reduced(arch), "cpu")
    mine = part.logical_specs(model)
    assert mine == _reference_specs(arch)
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    # the spec tree has the parameter tree's structure, a spec per dim
    part.tree_map_specs(lambda s, t: None if len(s) == t.ndim else
                        pytest.fail(f"{s} on {tuple(t.shape)}"), mine, params)


def test_placements_of_physical_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 4, "model": 8}
    assert part.placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert part.placements((None, None), mesh) == [Replicate()] * 3
    assert part.placements(("model", "data"), mesh) == \
        [Replicate(), Shard(1), Shard(0)]
    with pytest.raises(ValueError, match="order"):
        part.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="two dims"):
        part.placements(("model", "model"), mesh)
    rules = part.train_rules()
    assert rules.shard({"data": 2, "model": 4}, ("heads", None), (6, 8)) \
        == [Replicate(), Replicate()]           # 6 heads on 4: replicated
    assert rules.shard({"data": 2, "model": 4}, ("embed", "heads"),
                       (64, 8)) == [Shard(0), Shard(1)]


def test_sharding_plan_fits_every_leaf():
    model = Model(get_reduced("hymba-1.5b"), "cpu")
    params = model.init(torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    plan = part.ShardingPlan.of(params, model.logical_specs())
    assert plan.annotated
    mesh = {"data": 2, "model": 4}
    rules = part.train_rules()
    specs = plan.specs(mesh, rules)
    assert all(part.validate_divisibility(s, sp, mesh)
               for s, sp in zip(plan.shapes, specs))
    tree = plan.shardings(mesh, rules)
    want = part.shardings(model.logical_specs(), mesh, rules, params)
    assert tree == want
    avals = plan.avals()
    part.tree_map_specs(
        lambda _, a, t: None if (a.shape, a.dtype, a.device.type) ==
        (t.shape, t.dtype, "meta") else pytest.fail(str(a.shape)),
        model.logical_specs(), avals, params)


_SUBMESH = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "src")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distribution import replica_submesh, tp_submesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {"tp2": tp_submesh(mesh, 2).mesh.tolist(),
           "tp8_same": tp_submesh(mesh, 8) is mesh,
           "tp0_same": tp_submesh(mesh, 0) is mesh,
           "rep": [replica_submesh(mesh, i, 2).mesh.tolist()
                   for i in range(2)],
           "rep3": replica_submesh(mesh, 2, 3).mesh.tolist(),
           "rep1_same": replica_submesh(mesh, 0, 1) is mesh,
           "names": list(tp_submesh(mesh, 2).mesh_dim_names)}
    for bad in ((0, 5), (2, 2)):
        try:
            replica_submesh(mesh, *bad)
            out[str(bad)] = "no error"
        except ValueError as e:
            out[str(bad)] = str(e)
    print(json.dumps(out))
""")


def test_submeshes_slice_the_device_mesh():
    out = subprocess.run([sys.executable, "-c", _SUBMESH], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["tp2"] == [[0, 1], [4, 5]]
    assert got["tp8_same"] and got["tp0_same"] and got["rep1_same"]
    assert got["rep"] == [[[0, 1], [4, 5]], [[2, 3], [6, 7]]]
    assert got["rep3"] == [[2], [6]]          # column 3 idles
    assert got["names"] == ["data", "model"]
    assert "cannot tile" in got["(0, 5)"]
    assert "out of range" in got["(2, 2)"]
