"""Tensor-parallel serving of the port against the reference's, on the
CPU: the reference's mesh scenarios (``tests/test_fabric.py``: TP degrees,
live resharding, delta recomposition) run in one subprocess on 8 fake JAX
devices, the port's in one gloo world of 8 CPU ranks
(``tests/_torch_tp_worker.py``: one thread per rank, a ``file://``
rendezvous of its own).  Each side runs once per module; every test reads
the two runs.  Parameters cross with ``repro_torch.bridge`` from the
reference's ``model.init(jax.random.key(seed))``.

(a) minitron-reduced fp32 (4 query heads on 2 KV heads) at TP 1, 2 and 4
    and at TP 4 resharded to 2, 8 and back to 4 mid-stream: each stream
    equals the reference's and the port's unsharded engine's; the first
    decode step's logits at TP 4 are within 1e-5 of the unsharded ones,
    relative to the largest |logit|.  The same at TP 2 for qwen2.5-reduced
    (QKV bias, SwiGLU) and granite-reduced (MQA: one KV head, whole on
    every rank), and logits at TP 3 for 12 heads on 4 KV heads, whose
    groups straddle ranks.
(b) Ranks 0-3 grow to 0-5 (nothing divides 6: every leaf whole), shrink to
    0-1 and unify to 0-7 (vocab and FFN split, heads whole) mid-stream.
(c) bf16 at TP 2 against unsharded: logits within 3e-2 (the tolerance of
    tests/test_torch_model.py); streams part only after a top-2 margin
    under 5e-2 of the largest |logit|, and partings are counted.
(d) ``ComposedServer`` on (1, 8), three tenants 3/3/2, then
    ``recompose({"a": 4, "b": 2, "c": 2})``: the unmoved tenant keeps its
    grant, ranks and local tensors; the events and streams equal the
    reference's and a never-recomposed run's.
(e) ``apply(None, DesignPoint(tp=2))`` on a 4-column grant computes on the
    first two columns, stream unchanged.
(f) A warm recomposition builds ahead: the first step after the move
    builds nothing.
(g) ``--tp-smoke`` on the 8 ranks prints the reference's JSON; at world 1
    it exits 2, and ``--production-mesh`` under a world of 1 exits 2
    naming both sizes.
(h) Replicated engines on a mesh (``rules=None``): an SSM tenant moved
    mid-stream keeps its stream, as does an encoder engine its
    embeddings; the encoder engine under TP rules builds and encodes, its
    embeddings beside the unsharded ones (the sharded engines are held to
    the reference in ``tests/test_torch_tp_families.py`` and
    ``tests/test_torch_tp_encdec.py``).
(i) ``--production-mesh``'s serving on a (2, 4) mesh: one engine per data
    row over disjoint requests, each request's stream the reference's.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LOGIT_FP32_TOL = 1e-5
LOGIT_BF16_TOL = 3e-2          # tests/test_torch_model.py's
NEAR_TIE = 5e-2

_REFERENCE = """
import os, pickle, sys, io, contextlib
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses
import jax, numpy as np
import repro.serve.fabric as F
from repro.configs import get_reduced
from repro.core.composer import MeshComposer
from repro.distribution import strip
from repro.launch import serve as launch_serve
from repro.models import build_model
from repro.serve import ServeConfig, ServeEngine, serve_engine_rules

mesh = jax.make_mesh((1, 8), ("data", "model"))
comp = MeshComposer(mesh)
sc = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
rng = np.random.default_rng(0)
out = {"prompts": [rng.integers(1, 256, size=int(rng.integers(4, 12)))
                   for _ in range(3)]}

def fp32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")

def run(model, params, tp, rules, script=None, start=None):
    ids = start if start is not None else range(tp)
    eng = ServeEngine(model, params, sc, mesh=comp.submesh(ids, "t"),
                      rules=rules)
    for p in out["prompts"]:
        eng.submit(p, max_new_tokens=10)
    step = 0
    while eng.has_work:
        if script and step in script:
            eng.reshard_to(comp.submesh(script[step], "re"))
        eng.step()
        step += 1
        assert step < 200
    return {r: list(map(int, t)) for r, t in eng.results().items()}

rules = serve_engine_rules()
for arch in ("minitron-4b", "qwen2.5-32b", "granite-34b"):
    model = build_model(fp32(arch))
    params = model.init(jax.random.key(0))
    out[arch, "params"] = jax.tree.map(np.asarray, strip(params))
    out[arch, 1] = run(model, strip(params), 1, None)
    out[arch, 2] = run(model, params, 2, rules)
    if arch == "minitron-4b":
        out[arch, 4] = run(model, params, 4, rules)
        out[arch, "dyn"] = run(model, params, 4, rules,
                               {3: range(2), 7: range(8), 11: range(4)})
        out[arch, "recompose"] = run(
            model, params, 4, rules,
            {3: range(6), 7: range(2), 11: range(8)})

# the fabric: three minitron tenants, a manual delta recomposition
F.get_reduced = fp32
fsc = F.ServeConfig(max_slots=2, max_len=32, eos_id=-1)
srv = F.ComposedServer(mesh, [F.TenantSpec(n, "minitron-4b", seed=s,
                                           serve=fsc)
                              for n, s in (("a", 0), ("b", 1), ("c", 2))],
                       policy=None)
for n in "abc":
    out["fabric", n] = jax.tree.map(np.asarray,
                                    strip(srv.engines[n].params))
rids = []
for n in "abc":
    for p in out["prompts"][:2]:
        rids.append((n, srv.submit(n, p, max_new_tokens=10)))
for _ in range(3):
    srv.step()
srv.recompose({"a": 4, "b": 2, "c": 2})
res = srv.drain()
out["fabric_events"] = [[e.step, e.reason, e.sizes_after, e.design,
                         list(e.moved), list(e.unchanged)]
                        for e in srv.events]
out["fabric_streams"] = [[n, r, list(map(int, res[n][r]))]
                         for n, r in rids]

buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = launch_serve.main(["--tp-smoke"])
out["smoke"] = (rc, buf.getvalue().splitlines()[0])
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): each side's results, one run each."""
    d = tmp_path_factory.mktemp("tp")
    ref_path, port_path = d / "ref.pkl", d / "port.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(ref_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    out = subprocess.run([sys.executable,
                          str(ROOT / "tests" / "_torch_tp_worker.py"),
                          str(ref_path), str(port_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-6000:])
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(port_path, "rb") as f:
        port = pickle.load(f)
    return ref, port


def _streams(d):
    return {int(r): [int(t) for t in toks] for r, toks in d.items()}


@pytest.mark.parametrize("run", ["1", "2", "4", "dyn"])
def test_minitron_streams_equal_reference_and_unsharded(runs, run):
    ref, port = runs
    key = int(run) if run.isdigit() else run
    want = _streams(ref["minitron-4b", key])
    assert len(want) == 3 and all(len(t) == 10 for t in want.values())
    assert _streams(port["minitron-4b", key]) == want
    assert _streams(port["minitron-4b", "unsharded"]) == want


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "granite-34b"])
def test_tp2_streams_of_bias_and_mqa_archs(runs, arch):
    ref, port = runs
    want = _streams(ref[arch, 2])
    assert want == _streams(ref[arch, 1])
    assert _streams(port[arch, 2]) == want
    assert _streams(port[arch, "unsharded"]) == want


@pytest.mark.parametrize("arch,tp", [("minitron-4b", 4), ("minitron-4b", 8),
                                     ("qwen2.5-32b", 2),
                                     ("granite-34b", 2), ("straddle", 3)])
def test_first_step_logits_equal_unsharded(runs, arch, tp):
    """Prefill and first decode logits on the mesh against the unsharded
    model's ("straddle": 12 heads on 4 KV heads at TP 3, whose groups
    straddle ranks)."""
    _, port = runs
    got = port["logits", arch, tp]
    assert got["prefill"] <= LOGIT_FP32_TOL
    assert got["decode"] <= LOGIT_FP32_TOL


def test_local_shapes_follow_the_rules(runs):
    """What each degree splits on minitron-reduced (4 on 2 heads, d_ff 128,
    vocab 256): at 4 the query heads only, at 8 the vocab and FFN only."""
    _, port = runs
    assert port["shapes", 2] == {"wq": 2, "wk": 1, "w_up": 64, "embed": 128,
                                 "cache_k": 1}
    assert port["shapes", 4] == {"wq": 1, "wk": 2, "w_up": 32, "embed": 64,
                                 "cache_k": 2}
    assert port["shapes", 8] == {"wq": 4, "wk": 2, "w_up": 16, "embed": 32,
                                 "cache_k": 2}


def test_recomposition_grow_shrink_unify(runs):
    ref, port = runs
    want = _streams(ref["minitron-4b", "recompose"])
    assert _streams(port["recompose"]) == want
    assert want == _streams(ref["minitron-4b", 1])
    assert port["recompose_meshes"] == [[0, 1, 2, 3], [0, 1, 2, 3, 4, 5],
                                        [0, 1], list(range(8))]


def test_bf16_tp2_within_tolerance_and_partings_at_near_ties(runs):
    _, port = runs
    got = port["bf16"]
    assert got["logits"] <= LOGIT_BF16_TOL
    assert got["margins"] == [] or max(got["margins"]) < NEAR_TIE
    assert got["partings"] == len(got["margins"]) <= 3


def test_fabric_delta_recomposition(runs):
    ref, port = runs
    got = port["fabric"]
    assert got["c_same_sub"] and got["c_ranks"] == [[6, 7], [6, 7]]
    assert got["c_tensors_same"]
    assert len(got["a_ranks"]) == 4 and len(got["b_ranks"]) == 2
    assert got["events"] == ref["fabric_events"]
    assert got["streams"] == ref["fabric_streams"]
    assert got["streams"] == got["never_recomposed"]


def test_apply_tp_degree_narrows_the_grant(runs):
    ref, port = runs
    got = port["apply_tp"]
    assert got["applied"] == {"tp": 2} and got["ranks"] == [0, 1]
    assert got["design_tp"] == 2 and got["wq_heads"] == 2
    assert _streams(got["streams"]) == _streams(ref["minitron-4b", 1])


def test_warm_recompose_builds_nothing_after_the_move(runs):
    _, port = runs
    got = port["warm"]
    assert got["warm_builds"] >= 2
    assert got["cold_after_move"] == {"a": 0, "b": 0}
    assert got["ranks"] == {"a": 6, "b": 2}
    assert got["post_step_recorded"] == ["a", "b"]


def test_tp_smoke_prints_the_reference_json(runs):
    ref, port = runs
    rc, line = port["smoke"]
    assert rc == 0 == ref["smoke"][0]
    assert json.loads(line) == json.loads(ref["smoke"][1])
    assert json.loads(line)["ok"] is True


def test_tp_smoke_needs_two_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--tp-smoke", "--device", "cpu"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2, (out.stdout, out.stderr[-2000:])
    assert "tp-smoke needs >= 2 devices" in out.stdout


def test_production_mesh_needs_its_world():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "minitron-4b", "--reduced",
                          "--production-mesh", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2, (out.stdout, out.stderr[-2000:])
    assert "256" in out.stderr and "1" in out.stderr, out.stderr


def test_replicated_engines_on_a_mesh(runs):
    _, port = runs
    got = port["replicated"]
    assert got["ssm_moved"] == got["ssm_unsharded"]
    assert all(len(t) == 6 for t in got["ssm_unsharded"].values())
    assert got["encoder_moved"] == got["encoder_unsharded"]
    ruled, whole = got["encoder_ruled"], got["encoder_unsharded"]
    assert set(ruled) == set(whole) and len(whole) == 3
    for r in whole:
        # the unsharded side is rounded to 5 decimals
        assert np.allclose(ruled[r], whole[r], rtol=1e-5, atol=1e-5), r


def test_production_mesh_rows_serve_disjoint_requests(runs):
    ref, port = runs
    got = port["rows"]
    assert got["ranks"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert got["own_rows"] == [[0]] * 4 + [[1]] * 4
    assert got["slots"] == [1, 1]
    assert _streams(got["streams"]) == _streams(ref["minitron-4b", 1])
    emitted, one_engine = got["emitted"]
    assert emitted == one_engine > 0
