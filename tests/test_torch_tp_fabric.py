"""The policy-driven serving fabric on a mesh, the port against the
reference, on the CPU: the reference's ``ComposedServer(mesh, ...)``
scenarios run in one subprocess on 8 fake JAX devices (meshes with
``AxisType.Auto``), the port's in one gloo world of 8 CPU ranks
(``tests/_torch_tp_worker.py ... fabric``: one thread per rank, a
``file://`` rendezvous of its own), started as soon as the reference has
written its traffic and initial parameters (``init.pkl``).  Each side runs
once per module; every test reads the two runs.  Reduced configs in fp32;
parameters cross with ``repro_torch.bridge`` from the reference's
``model.init(jax.random.key(seed))``.

1. Policy: the reference's autoscale scenario (``tests/test_fabric.py``:
   two minitron tenants, ``decide_every`` 4) with both policies on the
   same platform numbers (the reference's ``TPU_V5E`` in the port's
   ``PlatformProfile``).  The events (step, reason, sizes after, design)
   equal the reference's and are the same on all 8 ranks; streams of
   [12, 12, 12] and [6] tokens equal the reference's and the port's
   unsharded replay (mesh-less engines, the recorded slot retunes at the
   recorded steps).  No decision of these reads a wall clock.
2. Stage 1 on a mesh: the reference's scenario of
   ``tests/test_serve_dse.py`` (minitron with ``slot_cap`` 4 and qwen2.5,
   ``decide_every`` 3): Stage 1 sees ``tp_allowed``, picks the reference's
   design points (dp 4, TP 2), recomposes, and a committed design point
   has a finite predicted/measured ratio.
3. EOS: an engine on a TP-4 sub-mesh and a two-tenant fabric on (1, 8),
   with an EOS id taken from the stream of a run without one: streams
   equal the reference's and the port's unsharded engine's, a request ends
   early, and the ranks outside a sub-mesh hold the same finished streams.
4. Preemption chaos (``tests/test_preempt_chaos.py``'s body): the reduced
   mixed fleet on the plain path, chaos seeds 3 and 11: the digest equals
   the run without chaos and the reference's, with preemptions and
   recompositions.
5. dp on a mesh: a tenant on a 4-column grant to dp 2 mid-stream (tiles of
   2 columns) and back to 1: events and streams equal the reference's and
   dp 1's.
6. The background prewarm: scenario 1 with ``prewarm_async``: the same
   decisions, committed a decide tick later and marked overlapped, the
   same streams, the same on every rank.
7. Divergent inputs: one rank observes a per-token p99 over target
   (a test hook in the worker): every rank applies the first rank's
   decision: no preemption when the hook is on rank 3, one on every rank
   when it is on rank 0, streams unchanged.
8. The NVLink profile: ``tp_collective_latency`` at p = 2, 4 and 8 is the
   ring formula by hand on 450e9 B/s, which ``derive_terms`` reads too;
   the launcher's ``--fabric --mesh-fabric`` at a world of one builds the
   mesh fabric on it.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.roofline import (CollectiveStats,  # noqa: E402
                                           derive_terms)
from repro_torch.common.platform import H100_NVLINK, H100_SXM  # noqa: E402
from repro_torch.core.analytical import (ICI_HOP_LATENCY_S,  # noqa: E402
                                         tp_collective_latency)

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = """
import os, pickle, sys
# one XLA thread: the reference shares the CPU with the port's 8 ranks
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
sys.path.insert(0, "src")
import dataclasses
import jax, numpy as np
from jax.sharding import AxisType
import repro.serve.fabric as F
from repro.configs import get_reduced
from repro.core.composer import MeshComposer
from repro.core.dse import DesignPoint
from repro.distribution import strip
from repro.launch.serve import MIXED_FLEET, _streams_digest
from repro.models import build_model
from repro.serve import ServeEngine, serve_engine_rules

def fp32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")

F.get_reduced = fp32
mesh = jax.make_mesh((1, 8), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
comp = MeshComposer(mesh)
FLEET = [(f"{w}-{a}", a, i, w) for i, (w, a) in enumerate(MIXED_FLEET)]
KEYS = sorted({("minitron-4b", 0), ("minitron-4b", 1), ("qwen2.5-32b", 1)}
              | {(a, i) for _, a, i, _ in FLEET})
out = {"params": {}, "fleet": FLEET}
models = {}
for arch, seed in KEYS:
    model = build_model(fp32(arch))
    params = model.init(jax.random.key(seed))
    models[arch, seed] = (model, params)
    out["params"][arch, seed] = jax.tree.map(np.asarray, strip(params))
vocab = {a: fp32(a).vocab_size for a, _ in KEYS}
rng = np.random.default_rng(0)
out["autoscale_traffic"] = (
    [("a", rng.integers(1, vocab["minitron-4b"], size=8), 12)
     for _ in range(3)]
    + [("b", rng.integers(1, vocab["minitron-4b"], size=8), 6)])
rng = np.random.default_rng(0)
out["dse_traffic"] = [(t, rng.integers(1, vocab[a], size=8), 10)
                      for t, a, n in (("a", "minitron-4b", 16),
                                      ("b", "qwen2.5-32b", 6))
                      for _ in range(n)]
rng = np.random.default_rng(1)
out["eos_prompts"] = [rng.integers(1, vocab["minitron-4b"],
                                   size=int(rng.integers(4, 12)))
                      for _ in range(4)]
rng = np.random.default_rng(5)
out["chaos_traffic"] = [(n, rng.integers(1, vocab[a],
                                         size=int(rng.integers(4, 16))), 8)
                        for n, a, _, _ in FLEET for _ in range(3)]
rng = np.random.default_rng(2)
out["dp_traffic"] = [(t, rng.integers(1, vocab["minitron-4b"],
                                      size=int(rng.integers(4, 12))), 12)
                     for t, n in (("a", 4), ("b", 2)) for _ in range(n)]
with open(sys.argv[2] + ".part", "wb") as f:
    pickle.dump(out, f)
os.rename(sys.argv[2] + ".part", sys.argv[2])


def serve(srv, traffic, script=None, max_steps=500):
    rids = [(t, srv.submit(t, p, max_new_tokens=n)) for t, p, n in traffic]
    step = 0
    while any(e.has_work for e in srv.engines.values()):
        if script and step in script:
            script[step](srv)
        srv.step()
        step += 1
        assert step < max_steps
    res = srv.results()
    return {"events": [[e.step, e.reason, e.sizes_after, e.design]
                       for e in srv.events],
            "streams": [[t, r, list(map(int, res[t][r]))] for t, r in rids]}


# 1. the autoscale scenario (tests/test_fabric.py)
sc = F.ServeConfig(max_slots=2, max_len=64, eos_id=-1)
srv = F.ComposedServer(mesh, [F.TenantSpec("a", "minitron-4b", serve=sc),
                              F.TenantSpec("b", "minitron-4b", seed=1,
                                           serve=sc)],
                       policy=F.AnalyticalPolicy(), decide_every=4)
out["autoscale"] = serve(srv, out["autoscale_traffic"])

# 2. Stage 1 on the mesh (tests/test_serve_dse.py)
sc = F.ServeConfig(max_slots=2, max_len=48, eos_id=-1)
srv = F.ComposedServer(mesh, [
    F.TenantSpec("a", "minitron-4b", serve=dataclasses.replace(sc,
                                                               slot_cap=4)),
    F.TenantSpec("b", "qwen2.5-32b", seed=1, serve=sc)],
    policy=F.AnalyticalPolicy(), decide_every=3)
out["dse"] = serve(srv, out["dse_traffic"])
out["dse"]["recompositions"] = srv.stats()["recompositions"]

# 3. EOS: an engine on a TP-4 sub-mesh, a fabric on (1, 8)
model, params = models["minitron-4b", 0]
rules = serve_engine_rules()


def engine_run(eos):
    sc = F.ServeConfig(max_slots=2, max_len=64, eos_id=eos)
    eng = ServeEngine(model, params, sc, mesh=comp.submesh(range(4), "t"),
                      rules=rules)
    for p in out["eos_prompts"]:
        eng.submit(p, max_new_tokens=10)
    while eng.has_work:
        eng.step()
    return {r: list(map(int, t)) for r, t in eng.results().items()}


free = engine_run(-1)
eos = int(free[0][4])
out["eos"] = {"id": eos, "free": free, "engine": engine_run(eos)}
sc = F.ServeConfig(max_slots=2, max_len=64, eos_id=eos)
srv = F.ComposedServer(mesh, [F.TenantSpec("a", "minitron-4b", serve=sc),
                              F.TenantSpec("b", "minitron-4b", seed=1,
                                           serve=sc)], policy=None)
out["eos"]["fabric"] = serve(srv, [(t, p, 10) for t in "ab"
                                   for p in out["eos_prompts"]])

# 4. the mixed fleet on the plain path, no chaos (tests/test_preempt_chaos.py)
serve_cfg = F.ServeConfig(max_slots=2, max_len=48, eos_id=-1,
                          kv_page_rows=8, use_kernels=False)
srv = F.ComposedServer(mesh, [F.TenantSpec(n, a, reduced=True,
                                           serve=serve_cfg, seed=i,
                                           workload=w)
                              for n, a, i, w in FLEET],
                       policy=None, warm=False)
run = serve(srv, out["chaos_traffic"], max_steps=3000)
out["chaos"] = {"digest": _streams_digest(srv.results()), **run}

# 5. dp on the mesh: a 4-column grant to dp 2 mid-stream and back
sc = F.ServeConfig(max_slots=2, max_len=64, eos_id=-1)
srv = F.ComposedServer(mesh, [
    F.TenantSpec("a", "minitron-4b", serve=sc, dp_cap=2),
    F.TenantSpec("b", "minitron-4b", seed=1, serve=sc)], policy=None)
out["dp"] = serve(srv, out["dp_traffic"], {
    3: lambda s: s.recompose({"a": DesignPoint(cus=4, dp=2), "b": 4}),
    8: lambda s: s.recompose({"a": DesignPoint(cus=4, dp=1), "b": 4})})
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): each side's results, one run each, side by
    side once the reference has written ``init.pkl``."""
    d = tmp_path_factory.mktemp("tpf")
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
                                 str(init_path), str(port_path), "fabric"],
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


def _same_everywhere(per_rank):
    assert len(per_rank) == 8
    assert all(x == per_rank[0] for x in per_rank)


def _lengths(streams):
    out = {}
    for t, _, toks in streams:
        out.setdefault(t, []).append(len(toks))
    return {t: sorted(v) for t, v in out.items()}


def test_policy_events_equal_reference_on_every_rank(runs):
    ref, port = runs
    got = port["policy"]["sync"]
    assert got["platform"] == "tpu_v5e"
    assert got["events"] == ref["autoscale"]["events"]
    assert len(got["events"]) >= 1
    _same_everywhere(got["ranks"])
    # a broadcast per decide tick, none on the other steps
    assert got["broadcasts"] == sum(
        1 for s in range(1, len(got["slo_per_step"]) + 1) if s % 4 == 0)


def test_policy_streams_equal_reference_and_unsharded_replay(runs):
    ref, port = runs
    got = port["policy"]["sync"]
    assert _lengths(got["streams"]) == {"a": [12, 12, 12], "b": [6]}
    assert got["streams"] == ref["autoscale"]["streams"]
    assert port["policy_replay"] == got["streams"]


def test_stage1_on_a_mesh_picks_the_reference_points(runs):
    ref, port = runs
    got = port["dse"]
    assert got["tp_allowed"] == [True]
    assert got["events"] == ref["dse"]["events"]
    assert got["recompositions"] == ref["dse"]["recompositions"] >= 1
    designs = [d for _, _, _, ev in got["events"] for d in ev.values()]
    assert any(d.get("dp", 1) > 1 for d in designs)
    assert any((d.get("tp") or 1) > 1 for d in designs)
    assert got["committed"] and all(0 < r < float("inf")
                                    for r in got["committed"].values())
    assert got["streams"] == ref["dse"]["streams"]
    _same_everywhere(got["ranks"])


def _ended_early(streams, new=10):
    return sum(len(t) < new for t in streams)


def test_eos_on_a_tp4_submesh(runs):
    ref, port = runs
    got = port["eos"]
    assert got["id"] == ref["eos"]["id"]
    want = ref["eos"]["engine"]
    assert got["engine"] == want == got["unsharded"]
    assert _ended_early(want.values()) >= 1
    # ranks 4-7 lie outside the sub-mesh and hold the same streams
    _same_everywhere(got["raw"])
    assert got["raw"][7] == want


def test_eos_on_a_fabric(runs):
    ref, port = runs
    got = port["eos"]
    want = ref["eos"]["fabric"]["streams"]
    assert got["fabric"]["streams"] == want
    assert _ended_early(t for _, _, t in want) >= 1
    _same_everywhere(got["fabric_raw"])


@pytest.mark.parametrize("seed", [3, 11])
def test_preemption_chaos_keeps_the_digest(runs, seed):
    ref, port = runs
    got = port["chaos"]
    digest, preempts, recomps = got[seed]
    assert digest == got[None][0] == ref["chaos"]["digest"]
    assert preempts >= 1 and recomps >= 1
    _same_everywhere(got["ranks"])


def test_replica_group_dp_on_a_mesh(runs):
    ref, port = runs
    got = port["dp"]
    assert got["events"] == ref["dp"]["events"]
    assert got["tiles"] == [[[0, 1], [2, 3]], [[0, 1, 2, 3]]]
    assert got["streams"] == ref["dp"]["streams"] == got["dp1"]
    assert _lengths(got["streams"]) == {"a": [12] * 4, "b": [12] * 2}


def test_background_prewarm_commits_the_same_decisions(runs):
    _, port = runs
    sync, warm = port["policy"]["sync"], port["policy"]["async"]
    # committed one decide tick (4 steps) after the decision
    assert [[s + 4] + e for s, *e in sync["events"]] == warm["events"]
    assert warm["overlapped"] == [True] * len(warm["events"])
    assert warm["streams"] == sync["streams"]
    _same_everywhere(warm["ranks"])


@pytest.mark.parametrize("hooked", ["3", "0"])
def test_divergent_inputs_take_the_first_ranks_decision(runs, hooked):
    _, port = runs
    runs_ = port["divergent"]
    got, base = runs_[hooked], runs_["None"]
    _same_everywhere(got["ranks"])
    slo_steps, _, preempts = got["ranks"][0]
    if hooked == "3":
        assert got["ranks"] == base["ranks"] and sum(slo_steps) == 0
    else:
        assert sum(slo_steps) >= 1 and preempts["a"] >= 1
    assert got["streams"] == base["streams"]
    # the SLO pass broadcasts every step while a tenant's SLO is tracked
    assert got["broadcasts"] >= len(slo_steps)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_nvlink_profile_prices_tp_collectives(p):
    nbytes = 8 * 3072 * 2          # one decode step's activations, bf16
    want = 2 * (p - 1) * (1.0e-6 + nbytes / (p * 450e9))
    assert ICI_HOP_LATENCY_S == 1.0e-6
    assert tp_collective_latency(H100_NVLINK, p, nbytes) == want
    assert H100_NVLINK.ici_bw * H100_NVLINK.ici_links == 450e9
    assert tp_collective_latency(H100_SXM, p, nbytes) == \
        2 * (p - 1) * 1.0e-6


def test_roofline_reads_the_same_nvlink_rate():
    stats = CollectiveStats(bytes_by_kind={"all-reduce": 9e9})
    terms = derive_terms(arch="a", cell="c", mesh_name="m", chips=8,
                         cost={"flops": 1.0, "bytes accessed": 1.0},
                         collective=stats, model_flops=1.0,
                         platform=H100_NVLINK)
    assert terms.collective_s == 9e9 / 450e9
    # the per-GPU numbers are H100_SXM's
    keep = lambda p: dict(dataclasses.asdict(p), name=0, ici_bw=0,
                          ici_links=0)
    assert keep(H100_SXM) == keep(H100_NVLINK)


def test_launcher_mesh_fabric_at_world_one():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--fabric",
         "--mesh-fabric", "--arch", "minitron-4b", "--reduced", "--device",
         "cpu", "--requests", "4", "--prewarm-async", "--log-every", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads(out.stdout)
    assert doc["mesh"] == [1, 1] and doc["tp"] is True
    assert doc["platform"] == "h100_sxm_nvlink" and doc["num_cus"] == 1
    assert doc["mesh_decisions"]["broadcasts"] >= 1
    # 4 requests of 16 tokens: 15 decode tokens each after the prefill's
    assert list(doc["tokens_emitted"].values()) == [60]
