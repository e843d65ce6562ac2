"""Tensor-parallel serving of the encoder and enc-dec engines on the CPU,
the port against the reference: seamless-reduced (2 + 2 layers, 4 heads
on 4 KV heads, a cross cache of 16 source rows) through ``EncDecEngine``
and qwen2.5-reduced (4 query heads on 2 KV heads) through
``EncoderEngine``, all fp32.  The reference's mesh scenarios run in one
subprocess on 8 fake JAX devices (meshes with ``AxisType.Auto``), the
port's in one gloo world of 8 CPU ranks (``tests/_torch_tp_worker.py ...
encdec``: one thread per rank, a ``file://`` rendezvous of its own).  Each
side runs once per module; every test reads the two runs.  Parameters
cross with ``repro_torch.bridge`` from the reference's
``model.init(jax.random.key(0))``.

(a) seamless-reduced greedy streams at TP 1, 2 and 4 and across the
    reference's reshard script {3: 1, 7: 4} from TP 2
    (``tests/test_workloads.py::test_encdec_streams_invariant_across_
    recomposition``) equal the reference's and the port's unsharded
    engine's.  The reference serves at TP 1 (its own test pins its streams
    across degrees).
(b) The [bos] prefill's and the first decode step's logits at TP 2 and 4
    within 1e-5 of the unsharded ones, relative to the largest |logit|.
(c) Every param and cache leaf's local shape, the cross cache's included,
    equals the reference's shard shape at TP 2 and 4.
(d) qwen2.5-reduced embeddings at TP 2 within the reference test's
    ``rtol=1e-5, atol=1e-6`` of the reference's at TP 2
    (``test_encoder_embeddings_invariant_across_moves``) and of the port's
    unsharded ones, and bitwise across a ``reshard_to`` of the same
    degree onto two other ranks.
(e) falcon-mamba-reduced (``mamba_fwd`` on d_in / 2 channels) and
    deepseek-v2-lite-reduced (``mla_fwd`` on 2 of 4 heads, 2 of 4 experts)
    as ``EncoderEngine`` tenants at TP 2, on the port's own seeded weights:
    the same tolerance against the unsharded engine.
(f) An enc-dec arch's tokens-as-frames encode at TP 2: each rank's
    vocab-split table gives the whole table's rows for every id (the
    masked lookup summed over the group), where a direct index into the
    local table would not; the encode within 1e-5 of the unsharded one.
(g) bf16 seamless at TP 2 within 3e-2 of unsharded; streams part only at
    top-2 margins under 5e-2 (counted).
(h) An encoder tenant and an enc-dec tenant on ``ComposedServer(mesh=...,
    tp=True)``, recomposed 4 + 4 -> 2 + 6 mid-stream: both ruled, the
    reference's events, enc-dec streams and (within (d)'s tolerance)
    embeddings.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SEAMLESS, QWEN = "seamless-m4t-medium", "qwen2.5-32b"
LOGIT_FP32_TOL = 1e-5
LOGIT_BF16_TOL = 3e-2          # tests/test_torch_model.py's
NEAR_TIE = 5e-2
RTOL, ATOL = 1e-5, 1e-6        # the reference test's embedding tolerance
ENCODE_TOL = 1e-5

_REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses
import jax, numpy as np
from jax.sharding import AxisType
import repro.serve.fabric as F
from repro.configs import get_reduced
from repro.core.composer import MeshComposer
from repro.distribution import strip
from repro.models import build_model
from repro.serve import ServeConfig, serve_engine_rules
from repro.workloads import EncDecEngine, EncoderEngine

mesh = jax.make_mesh((1, 8), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
comp = MeshComposer(mesh)
rules = serve_engine_rules()
SEAMLESS, QWEN = "seamless-m4t-medium", "qwen2.5-32b"
dsc = ServeConfig(max_slots=2, max_len=24, eos_id=-1, max_src_len=16,
                  len_buckets=(8,))
esc = ServeConfig(max_slots=2, max_len=32)
rng = np.random.default_rng(0)
out = {"srcs": [rng.integers(1, 256, size=L) for L in (5, 9, 7, 13)],
       "jobs": [rng.integers(1, 256, size=int(rng.integers(4, 20)))
                for _ in range(5)]}


def fp32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def shard_shapes(tree):
    return jax.tree.map(lambda a: tuple(a.sharding.shard_shape(a.shape)),
                        tree)


models = {}
for arch in (SEAMLESS, QWEN):
    model = build_model(fp32(arch))
    params = model.init(jax.random.key(0))
    models[arch] = (model, params)
    out[arch, "params"] = jax.tree.map(np.asarray, strip(params))

F.get_reduced = fp32
fsc = {"e": F.ServeConfig(max_slots=2, max_len=32, eos_id=-1),
       "d": F.ServeConfig(max_slots=2, max_len=24, eos_id=-1,
                          max_src_len=16, len_buckets=(8,))}
srv = F.ComposedServer(mesh, [
    F.TenantSpec("e", QWEN, seed=0, serve=fsc["e"], workload="encoder"),
    F.TenantSpec("d", SEAMLESS, seed=1, serve=fsc["d"])], policy=None)
for n in "ed":
    out["fabric", n] = jax.tree.map(np.asarray, strip(srv.engines[n].params))
with open(sys.argv[2] + ".part", "wb") as f:
    pickle.dump(out, f)
os.rename(sys.argv[2] + ".part", sys.argv[2])

model, params = models[SEAMLESS]
eng = EncDecEngine(model, strip(params), dsc,
                   mesh=comp.submesh(range(1), "tp1"))
for s in out["srcs"]:
    eng.submit(s, max_new_tokens=8)
while eng.has_work:
    eng.step()
out[SEAMLESS, 1] = {r: list(map(int, t)) for r, t in eng.results().items()}
shapes = {}
for tp in (2, 4):
    e = EncDecEngine(model, params, dsc,
                     mesh=comp.submesh(range(tp), f"tp{tp}"), rules=rules)
    shapes[tp] = (shard_shapes(e.params), shard_shapes(e.cache))
out[SEAMLESS, "shapes"] = shapes

model, params = models[QWEN]
e = EncoderEngine(model, params, esc, mesh=comp.submesh(range(2), "enc"),
                  rules=rules)
for j in out["jobs"]:
    e.submit(j)
    e.step()
out[QWEN, 2] = {r: list(map(float, v)) for r, v in e.results().items()}

rids = []
for j in out["jobs"][:3]:
    rids.append(("e", srv.submit("e", j)))
for s in out["srcs"][:3]:
    rids.append(("d", srv.submit("d", s, max_new_tokens=8)))
for _ in range(3):
    srv.step()
srv.recompose({"e": 2, "d": 6})
res = srv.drain()
out["fabric_events"] = [[e.step, e.reason, e.sizes_after, e.design,
                         list(e.moved), list(e.unchanged)]
                        for e in srv.events]
out["fabric_streams"] = [[n, r, list(map(float if n == "e" else int,
                                          res[n][r]))] for n, r in rids]
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): each side's results, one run each.  The port's
    side starts as soon as the reference has written its sources, jobs and
    initial parameters (``init.pkl``), and the two run side by side."""
    d = tmp_path_factory.mktemp("tpe")
    ref_path, init_path, port_path = (d / "ref.pkl", d / "init.pkl",
                                      d / "port.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    logs = [open(d / n, "w+") for n in ("ref.log", "port.log")]
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(ref_path),
                            str(init_path)], cwd=ROOT, env=env,
                           stdout=logs[0], stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 600
    while not init_path.exists() and ref.poll() is None:
        assert time.monotonic() < deadline, "reference: no init.pkl"
        time.sleep(0.2)
    port = None
    if init_path.exists():
        port = subprocess.Popen([sys.executable,
                                 str(ROOT / "tests" / "_torch_tp_worker.py"),
                                 str(init_path), str(port_path), "encdec"],
                                cwd=ROOT, env=env, stdout=logs[1],
                                stderr=subprocess.STDOUT)
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 1))
               if p is not None else None for p in (ref, port)]
    finally:
        for p in (ref, port):
            if p is not None and p.poll() is None:
                p.kill()
    text = []
    for f in logs:
        f.seek(0)
        text.append(f.read()[-6000:])
        f.close()
    assert rcs == [0, 0], (rcs, text)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(port_path, "rb") as f:
        port = pickle.load(f)
    return ref, port


def _streams(d):
    return {int(r): [int(t) for t in toks] for r, toks in d.items()}


def _close(got, want):
    """Every job's embedding within the reference test's tolerance."""
    assert set(got) == set(want) and len(want) == 5
    for r in want:
        assert len(got[r]) == len(want[r]) == 64
        assert np.allclose(got[r], want[r], rtol=RTOL, atol=ATOL), r


@pytest.mark.parametrize("run", ["1", "2", "4", "dyn"])
def test_encdec_streams_equal_reference_and_unsharded(runs, run):
    ref, port = runs
    key = int(run) if run.isdigit() else run
    want = _streams(ref[SEAMLESS, 1])
    assert len(want) == 4 and all(len(t) == 8 for t in want.values())
    assert _streams(port[SEAMLESS, key]) == want
    assert _streams(port[SEAMLESS, "unsharded"]) == want


@pytest.mark.parametrize("tp", [2, 4])
def test_encdec_first_step_logits_equal_unsharded(runs, tp):
    _, port = runs
    got = port["logits", tp]
    assert got["prefill"] <= LOGIT_FP32_TOL
    assert got["decode"] <= LOGIT_FP32_TOL


def _flat(tree, path=()):
    """{path: shape} of a nested dict/list tree of shape tuples."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in
                _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and not all(
            isinstance(n, int) for n in tree)):
        return {k: v for i, t in enumerate(tree) for k, v in
                _flat(t, path + (i,)).items()}
    return {path: tuple(tree)}


def _reference_params(ref_tree, n_layers):
    """The reference's param shard shapes in the port's tree structure:
    each scanned leaf of the encoder and the decoder, less its leading
    "layers" axis, once per layer."""
    out = {}
    for path, shape in _flat(ref_tree).items():
        if len(path) > 1 and path[1] == "scanned":
            n = n_layers[path[0] == "decoder"]
            for i in range(n):
                out[(path[0], "layers", i) + path[2:]] = shape[1:]
        else:
            out[path] = shape
    return out


def _reference_cache(ref_tree):
    """The reference's cache shard shapes in the port's structure: its
    stacked ``cross_k``/``cross_v`` are the port's ``cross`` ``k``/``v``."""
    out = {}
    for path, shape in _flat(ref_tree).items():
        if path[-1] in ("cross_k", "cross_v"):
            path = path[:-1] + ("cross", path[-1][-1])
        out[path] = shape
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_encdec_local_shapes_equal_reference_shards(runs, tp):
    """Every param leaf's local shape is the reference's shard shape, and
    every cache leaf's: the decoder KV and the cross cache on their KV
    heads (4 / tp of them), positions and source lengths whole."""
    ref, port = runs
    params, cache = ref[SEAMLESS, "shapes"][tp]
    mine = port["shapes", tp]
    assert _reference_params(params, mine["n_layers"]) == mine["params"]
    assert _reference_cache(cache) == mine["cache"]
    cross = mine["cache"][("scanned", "cross", "k")]
    assert cross[3] == 4 // tp


def test_encoder_embeddings_close_to_reference_and_unsharded(runs):
    ref, port = runs
    got = port[QWEN, "encoder"]
    _close(got["tp2"], ref[QWEN, 2])
    _close(got["tp2"], got["unsharded"])


def test_encoder_embeddings_bitwise_across_a_reshard(runs):
    _, port = runs
    got = port[QWEN, "encoder"]
    assert got["moved"] == got["tp2"]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "deepseek-v2-lite-16b"])
def test_encoder_tenants_on_local_shards(runs, arch):
    _, port = runs
    got = port[arch, "encoder"]
    _close(got["tp2"], got["unsharded"])


def test_tokens_as_frames_lookup_on_a_vocab_split_table(runs):
    _, port = runs
    ranks = port["frames"]
    assert len(ranks) == 2
    for got in ranks:
        assert got["rows"] == 128                  # half the vocab a rank
        assert got["lookup_exact"]
        assert not got["direct_rows_right"]
        assert got["encode"] <= ENCODE_TOL


def test_bf16_tp2_within_tolerance_and_partings_at_near_ties(runs):
    _, port = runs
    got = port["bf16"]
    assert got["logits"] <= LOGIT_BF16_TOL
    assert got["margins"] == [] or max(got["margins"]) < NEAR_TIE
    assert got["partings"] == len(got["margins"]) <= 2


def test_fabric_encoder_and_encdec_tenants_recompose(runs):
    ref, port = runs
    got = port["fabric"]
    assert got["ranks_before"] == {"e": 4, "d": 4}
    assert got["ranks_after"] == {"e": 2, "d": 6}
    assert got["ruled"] == {"e": True, "d": True}
    assert got["events"] == ref["fabric_events"]
    assert len(got["streams"]) == len(ref["fabric_streams"]) == 6
    for (n, r, mine), (n2, r2, want) in zip(got["streams"],
                                            ref["fabric_streams"]):
        assert (n, r) == (n2, r2)
        if n == "d":
            assert [int(t) for t in mine] == want
        else:
            assert np.allclose(mine, want, rtol=RTOL, atol=ATOL)
