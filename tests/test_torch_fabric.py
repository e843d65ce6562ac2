"""The port's serving fabric on the CPU.

1. Against the JAX fabric: one subprocess with 8 fake host devices runs
   the reference ``ComposedServer`` (``tp=False``) over two tenants,
   reduced minitron-4b and reduced falcon-mamba-7b in fp32, 2 slots each,
   ``decide_every`` 4, a fixed traffic; it writes its events and streams
   as JSON and its initial params as ``.npz``.  The port's
   ``ComposedServer(num_cus=8, device="cpu", params=bridged)`` serves the
   same traffic with the same prices (a policy holding the reference's
   per-chip profile numbers as one CU): the event sequence (step, reason,
   sizes after, design applied) and every stream must be equal.
   The same subprocess runs the reference's mixed fleet (one tenant per
   workload class: minitron-4b decode, falcon-mamba-7b SSM, qwen2.5-32b
   encoder, seamless-m4t-medium enc-dec, reduced, fp32) on traffic with
   forced prefixes and precomputed frames: events and token streams must
   be equal, embeddings within 1e-5 of the largest |value|.
2. The reference's fabric scenarios (``tests/test_fabric.py``), one to one,
   as CPU tests of the port: a CU is a share of one device, so "devices"
   become CU ids and a move builds nothing (a slot retune does).
3. The launcher's mixed-fleet modes on the CPU: ``--scenario`` JSON,
   ``--slo-smoke`` and ``--obs-smoke``.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.common.platform import PlatformProfile  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.composer import CUComposer  # noqa: E402
from repro_torch.core.dse import DesignPoint  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import fabric  # noqa: E402
from repro_torch.serve.fabric import (AnalyticalPolicy,  # noqa: E402
                                      ComposedServer, ReplicaGroup,
                                      TenantSpec)
from repro_torch.workloads import DECODE, ServeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the reference's per-chip TPU_V5E numbers as one CU of the port's policy
# (held to the reference's record in tests/test_torch_fabric_policy.py)
TPU_NUMBERS = PlatformProfile(
    name="tpu_v5e", peak_flops=197e12, atom_shape=(8, 128, 128),
    atom_cycles=8.0, compute_clock_hz=0.94e9, num_compute_units=4,
    hbm_bytes=16 << 30, hbm_bw=819e9, onchip_bytes=128 << 20,
    onchip_bw=22e12, ici_bw=50e9, ici_links=4, instr_bytes=32,
    reconfig_cycles=16.0, bitstream_reload_s=10.0)
FLEET = (("a", "minitron-4b", 0), ("b", "falcon-mamba-7b", 1))
SERVE = dict(max_slots=2, max_len=64, eos_id=-1)

_JAX_FABRIC = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, "src")
import dataclasses
import json
import jax
import numpy as np
import repro.serve.fabric as F
from repro.configs import get_reduced
from repro.distribution import strip

# fp32 tenants: the reference's TenantSpec builds bf16 configs
F.get_reduced = lambda arch: dataclasses.replace(get_reduced(arch),
                                                 dtype="float32")
out = sys.argv[1]
fleet = json.loads(sys.argv[2])
serve = F.ServeConfig(**json.loads(sys.argv[3]))
traffic = json.load(open(out + "/traffic.json"))
mesh = jax.make_mesh((1, 8), ("data", "model"))
srv = F.ComposedServer(mesh, [F.TenantSpec(n, a, seed=s, serve=serve,
                                          workload=(w or ["auto"])[0])
                              for n, a, s, *w in fleet],
                       policy=F.AnalyticalPolicy(), decide_every=4,
                       tp=False, warm=True)


def flat(tree, pre, acc):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, pre + (k,), acc)
    else:
        acc["/".join(pre)] = np.asarray(tree)
    return acc


for n, *_ in fleet:
    np.savez(f"{out}/params_{n}.npz",
             **flat(jax.tree.map(np.asarray, strip(srv.engines[n].params)),
                    (), {}))
rids, step = [], 0
while traffic or any(e.has_work for e in srv.engines.values()):
    while traffic and traffic[0][0] <= step:
        _, t, toks, new, *kw = traffic.pop(0)
        src = np.asarray(toks)
        src = src.astype(np.float32 if src.ndim == 2 else np.int32)
        rids.append((t, srv.submit(t, src, max_new_tokens=new,
                                   **(kw[0] if kw else {}))))
    srv.step()
    step += 1
    assert step < 500
res = srv.results()
json.dump({"events": [[e.step, e.reason, e.sizes_after, e.design]
                      for e in srv.events],
           "streams": [[t, r, [float(x) for x in res[t][r]]]
                       for t, r in rids]},
          open(out + "/jax.json", "w"), default=list)
"""


def _traffic():
    """(step, tenant, prompt, new tokens): a minitron burst, a falcon
    request, a falcon burst, a late minitron request — a rebalance each
    way, then a unify."""
    rng = np.random.default_rng(0)
    out = []
    for step, t, n, new in ((0, "a", 3, 12), (0, "b", 1, 6), (9, "b", 3, 10),
                            (22, "a", 1, 8)):
        for _ in range(n):
            plen = int(rng.integers(4, 20))
            out.append((step, t, rng.integers(3, 200, size=plen).tolist(),
                        new))
    return out


def _unflat(npz):
    tree = {}
    for key in npz.files:
        if npz[key].size == 0:            # an empty subtree (no prologue)
            continue
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[key]
    return tree


def _fp32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _serve_traffic(srv, traffic):
    traffic = list(traffic)
    rids, step = [], 0
    while traffic or any(e.has_work for e in srv.engines.values()):
        while traffic and traffic[0][0] <= step:
            _, t, toks, new, *kw = traffic.pop(0)
            src = np.asarray(toks)
            src = src.astype(np.float32 if src.ndim == 2 else np.int32)
            rids.append((t, srv.submit(t, src, max_new_tokens=new,
                                       **(kw[0] if kw else {}))))
        srv.step()
        step += 1
        assert step < 500
    res = srv.results()
    return [[t, r, list(res[t][r])] for t, r in rids]


def _run_jax_fabric(out, fleet, traffic):
    """The reference fabric over ``fleet`` on ``traffic``, in one
    8-fake-device subprocess: its events, streams and initial params."""
    (out / "traffic.json").write_text(json.dumps(traffic))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_FABRIC), str(out),
         json.dumps(fleet), json.dumps(SERVE)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-4000:])
    assert time.perf_counter() - t0 < 300
    ref = json.loads((out / "jax.json").read_text())
    params = {n: params_from_jax(_unflat(np.load(out / f"params_{n}.npz")),
                                 _fp32(arch), "cpu")
              for n, arch, *_ in fleet}
    return ref, params, traffic


@pytest.fixture(scope="module")
def jax_fabric(tmp_path_factory):
    """The reference fabric's events, streams and initial params, from one
    8-fake-device subprocess (about 30 s)."""
    return _run_jax_fabric(tmp_path_factory.mktemp("jax_fabric"), FLEET,
                           _traffic())


def _port_fabric(params, telemetry=True, fleet=FLEET):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fabric, "get_reduced", _fp32)
        return ComposedServer(
            [TenantSpec(n, a, seed=s, serve=ServeConfig(**SERVE),
                        workload=(w or ["auto"])[0])
             for n, a, s, *w in fleet],
            num_cus=8, device="cpu", params=params,
            policy=AnalyticalPolicy(TPU_NUMBERS), decide_every=4,
            warm=True, telemetry=telemetry)


def test_events_and_streams_equal_jax_fabric(jax_fabric):
    ref, params, traffic = jax_fabric
    srv = _port_fabric(params)
    streams = _serve_traffic(srv, traffic)
    events = [[e.step, e.reason, e.sizes_after, e.design]
              for e in srv.events]
    assert json.loads(json.dumps(events, default=list)) == ref["events"]
    assert len(ref["events"]) >= 2
    assert {e[1] for e in ref["events"]} >= {"rebalance", "unify"}
    assert streams == ref["streams"]
    assert [len(s) for _, _, s in streams] == [12, 12, 12, 6, 10, 10, 10, 8]


def test_streams_equal_with_telemetry_off(jax_fabric):
    ref, params, traffic = jax_fabric
    srv = _port_fabric(params, telemetry=False)
    assert _serve_traffic(srv, traffic) == ref["streams"]
    assert len(srv.obs.tracer) == 0 and not srv.decode_step_ms()


def test_fabric_telemetry_surfaces(jax_fabric):
    """stats(), the ledger, slo_summary, metrics and the trace after the
    parity run: every event's touched tenants committed a prediction, the
    serving path captured nothing (eager on the CPU)."""
    _, params, traffic = jax_fabric
    srv = _port_fabric(params)
    _serve_traffic(srv, traffic)
    st = srv.stats()
    assert st["recompositions"] == len(srv.events) >= 2
    assert st["serving_captures"] == {"a": 0, "b": 0}
    # a prefill's first token reaches the stream, not a step's output
    assert sum(st["tokens_emitted"].values()) == \
        3 * 12 + 6 + 3 * 10 + 8 - 8
    led = srv.ledger.summary()
    assert any(e["commits"] for e in led["entries"].values())
    assert any(e["measured_n"] for e in led["entries"].values())
    summ = srv.slo_summary()
    assert set(summ["tenants"]) == {"a", "b"}
    assert "ttft_ms" in summ["tenants"]["a"]
    snap = srv.metrics_snapshot()
    assert snap["counters"]["recompositions_total"] == len(srv.events)
    names = {e["name"] for e in srv.obs.tracer.to_json()["traceEvents"]}
    assert {"decide", "recompose", "migrate"} <= names


# the reference launcher's MIXED_FLEET, reduced: one tenant per class
MIXED = (("d", "minitron-4b", 0, "decode"), ("s", "falcon-mamba-7b", 1, "ssm"),
         ("e", "qwen2.5-32b", 2, "encoder"),
         ("x", "seamless-m4t-medium", 3, "encdec"))


def _mixed_traffic():
    """(step, tenant, source, new tokens, submit keywords): embedding jobs
    and enc-dec jobs beside a decode burst and SSM requests; the enc-dec
    tenant gets a forced prefix and precomputed (S, d_model) frames."""
    rng = np.random.default_rng(1)
    out = []
    for step, t, n, new in ((0, "d", 3, 10), (0, "e", 4, 0), (0, "x", 2, 8),
                            (5, "s", 2, 8), (9, "e", 3, 0), (12, "x", 2, 6),
                            (20, "d", 1, 6)):
        for _ in range(n):
            plen = int(rng.integers(4, 20))
            out.append((step, t, rng.integers(3, 200, size=plen).tolist(),
                        new))
    d = get_reduced("seamless-m4t-medium").d_model
    out.append((14, "x", rng.integers(3, 200, size=7).tolist(), 6,
                {"prefix": [5, 9, 11]}))
    out.append((14, "x", (0.5 * rng.normal(size=(9, d))).tolist(), 5))
    return sorted(out, key=lambda a: a[0])


@pytest.fixture(scope="module")
def jax_mixed_fabric(tmp_path_factory):
    """The reference fabric over the mixed fleet, one 8-fake-device
    subprocess."""
    return _run_jax_fabric(tmp_path_factory.mktemp("jax_mixed"), MIXED,
                           _mixed_traffic())


def test_mixed_fleet_events_and_streams_equal_jax_fabric(jax_mixed_fabric):
    """The four classes on one fabric, priced by the same policy: the
    event sequence and every token stream equal the reference's, each
    embedding within 1e-5 of the largest |value|."""
    ref, params, traffic = jax_mixed_fabric
    srv = _port_fabric(params, fleet=MIXED)
    streams = _serve_traffic(srv, traffic)
    events = [[e.step, e.reason, e.sizes_after, e.design]
              for e in srv.events]
    assert json.loads(json.dumps(events, default=list)) == ref["events"]
    assert len(ref["events"]) >= 1
    assert [s[:2] for s in streams] == [s[:2] for s in ref["streams"]]
    for (t, r, got), (_, _, want) in zip(streams, ref["streams"]):
        if t == "e":
            got, want = np.asarray(got), np.asarray(want)
            assert got.shape == want.shape == (64,)
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        else:
            assert got == [int(x) for x in want], (t, r)
    st = srv.stats()
    assert st["workload_classes"] == {"d": "decode", "s": "ssm",
                                      "e": "encoder", "x": "encdec"}
    assert st["tokens_emitted"]["e"] == 7
    assert srv.src_lens == {"x": SERVE["max_len"]}


# ---------------------------------------------------------------------------
# the reference's fabric scenarios, on the port
# ---------------------------------------------------------------------------

def _sc(**kw):
    cfg = dict(max_slots=2, max_len=32, eos_id=-1)
    cfg.update(kw)
    return ServeConfig(**cfg)


def test_composed_server_delta_leaves_unmoved_tenant_cus():
    """recompose: the unchanged tenant keeps the SAME grant (its CU ids);
    moved tenants' grants hold their new CU counts and shares."""
    srv = ComposedServer([
        TenantSpec("a", "minitron-4b", serve=_sc()),
        TenantSpec("b", "minitron-4b", seed=1, serve=_sc()),
        TenantSpec("c", "minitron-4b", seed=2, serve=_sc()),
    ], num_cus=8, device="cpu", policy=None)      # sizes: a=3, b=3, c=2
    c_before = srv.subs["c"]
    ev = srv.recompose({"a": 4, "b": 2, "c": 2})
    assert srv.subs["c"] is c_before and srv.subs["c"].cu_ids == (6, 7)
    assert list(ev.unchanged) == ["c"] and sorted(ev.moved) == ["a", "b"]
    assert len(srv.subs["a"].cu_ids) == 4 and len(srv.subs["b"].cu_ids) == 2
    assert srv.subs["a"].share == 0.5 and srv.subs["b"].share == 0.25
    assert not set(srv.subs["a"].cu_ids) & set(srv.subs["b"].cu_ids)


def test_warm_recompose_skips_post_move_compile():
    """With warming on, the target design points' steps are built before
    the switch commits: the first post-move step builds nothing.  On one
    device a move builds nothing; the slot retune of ``a`` builds its new
    pool's steps ahead."""
    srv = ComposedServer([
        TenantSpec("a", "minitron-4b", serve=_sc()),
        TenantSpec("b", "minitron-4b", seed=1, serve=_sc()),
    ], num_cus=8, device="cpu", policy=None, warm=True)
    rng = np.random.default_rng(0)
    vocab = srv.cfgs["a"].vocab_size
    for t in ("a", "b"):
        srv.submit(t, rng.integers(1, vocab, size=8), max_new_tokens=16)
    for _ in range(3):
        srv.step()
    ev = srv.recompose({"a": DesignPoint(cus=6, slots=4), "b": 2})
    builds = {t: srv.engines[t].compile_builds for t in "ab"}
    srv.step()
    assert ev.warm_builds >= 1 and ev.warm_compile_seconds > 0
    assert ev.design == {"a": {"slots": 4}}
    assert {t: srv.engines[t].compile_builds - builds[t] for t in "ab"} \
        == {"a": 0, "b": 0}
    assert srv.sizes() == {"a": 6, "b": 2}
    assert sorted(ev.post_step_seconds) == ["a", "b"]


def test_prewarm_async_commits_after_background_compile():
    """prewarm_async: the chosen composition warms in a background thread
    while the old one keeps serving; the switch commits on a later tick,
    marked ``overlapped``, and every request completes its budget."""
    srv = ComposedServer([
        TenantSpec("a", "minitron-4b", serve=_sc(max_len=64)),
        TenantSpec("b", "minitron-4b", seed=1, serve=_sc(max_len=64)),
    ], num_cus=8, device="cpu", policy=AnalyticalPolicy(), decide_every=2,
        prewarm_async=True)
    rng = np.random.default_rng(0)
    vocab = srv.cfgs["a"].vocab_size
    for _ in range(4):
        srv.submit("a", rng.integers(1, vocab, size=8), max_new_tokens=24)
    steps = 0
    while (not srv.events) and steps < 300:
        srv.step()
        if srv._pending_prewarm is not None:
            time.sleep(0.05)      # let the warm-up thread make progress
        steps += 1
    out = srv.drain(max_steps=400)
    assert len(srv.events) >= 1
    assert srv.events[0].overlapped is True
    assert sorted(len(v) for v in out["a"].values()) == [24, 24, 24, 24]


def _group(sc, dp0=1):
    cfg = get_reduced("minitron-4b")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    comp = CUComposer(8, "cpu")
    grp = ReplicaGroup(DECODE, model, params, sc,
                       sub=comp.submesh(range(4), "t"))
    grp.apply(None, DesignPoint(cus=4, tp=1, dp=dp0))
    return grp, cfg


def test_replica_group_routing_and_merged_stats():
    """Least-loaded routing keeps owed work balanced across replicas, the
    group-merged load signals equal the sums over ``per_replica``, every
    request completes under its stable group rid, and the replicas share
    one set of parameter tensors."""
    grp, cfg = _group(_sc(max_len=64), dp0=4)
    assert all(e.params is grp.params for e in grp.replicas)
    rng = np.random.default_rng(0)
    budgets = [32, 2, 32, 2, 32, 2, 32, 2]
    rids = [grp.submit(rng.integers(1, cfg.vocab_size, size=6),
                       max_new_tokens=b) for b in budgets]
    owed = [r.pending_tokens() for r in grp.replicas]
    queued = [r.queue_depth + r.active_count for r in grp.replicas]
    st = grp.stats()
    assert st["dp"] == 4 and len(st["per_replica"]) == 4
    assert st["pending_tokens"] == sum(owed) == grp.pending_tokens()
    assert st["queue_depth"] == sum(r.queue_depth for r in grp.replicas)
    assert st["active"] == sum(r.active_count for r in grp.replicas)
    assert abs(st["arena_utilization"]
               - sum(r.arena_utilization() for r in grp.replicas) / 4) < 1e-6
    grp.reshard_to(CUComposer(8, "cpu").submesh(range(4, 8), "u"))
    assert grp._granted.cu_ids == (4, 5, 6, 7) and grp.dp == 4
    out = grp.run_to_completion(400)
    assert rids == list(range(8))
    assert min(queued) >= 1 and max(owed) - min(owed) < 32
    assert {r: len(out[r]) for r in rids} == dict(enumerate(budgets))


def test_dp_replica_streams_bit_identical():
    """Which replica serves a request never changes its tokens: dp=2
    streams equal dp=1's, and so do those of a run whose replica count is
    retuned mid-stream (1 -> 2 -> 4 -> 1) while requests are live."""
    cfg = get_reduced("minitron-4b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 12)))
               for _ in range(4)]

    def run(dp0, script):
        grp, _ = _group(_sc(max_slots=4, max_len=64), dp0)
        for p in prompts:
            grp.submit(p, max_new_tokens=10)
        step = 0
        while grp.has_work:
            if step in script:
                grp.apply(None, DesignPoint(cus=4, dp=script[step]))
            grp.step()
            step += 1
            assert step < 200
        return grp.results()

    ref = run(1, {})
    assert len(ref) == 4
    assert run(2, {}) == ref
    assert run(1, {3: 2, 6: 4, 9: 1}) == ref


def test_warm_compile_stages_growth_replicas():
    """warm_compile of a dp growth builds and warms the replicas it would
    add; the retune takes them over, and their steps build nothing."""
    grp, cfg = _group(_sc(max_len=64), dp0=1)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grp.submit(rng.integers(1, cfg.vocab_size, size=6),
                   max_new_tokens=12)
    grp.step()
    point = DesignPoint(cus=4, dp=2)
    assert grp.warm_compile(None, point) >= 1
    staged = grp._staged[1].engine
    grp.apply(None, point)
    assert grp.replicas[1] is staged and not grp._staged
    builds = staged.compile_builds
    out = grp.run_to_completion(200)
    assert staged.compile_builds == builds
    assert sorted(len(v) for v in out.values()) == [12, 12, 12]


def test_traffic_driven_autoscale_end_to_end():
    """Policy-driven fabric: a burst triggers at least one recomposition and
    every request still completes with its full token budget."""
    srv = ComposedServer([
        TenantSpec("a", "minitron-4b", serve=_sc(max_len=64)),
        TenantSpec("b", "minitron-4b", seed=1, serve=_sc(max_len=64)),
    ], num_cus=8, device="cpu", policy=AnalyticalPolicy(), decide_every=4)
    rng = np.random.default_rng(0)
    vocab = srv.cfgs["a"].vocab_size
    for _ in range(3):
        srv.submit("a", rng.integers(1, vocab, size=8), max_new_tokens=12)
    srv.submit("b", rng.integers(1, vocab, size=8), max_new_tokens=6)
    out = srv.drain(max_steps=400)
    assert len(srv.events) >= 1
    lens = {t: sorted(len(v) for v in d.values()) for t, d in out.items()}
    assert lens == {"a": [12, 12, 12], "b": [6]}


def test_launcher_fabric_mode_json(capsys):
    """``python -m repro_torch.launch.serve --fabric`` on the CPU: one JSON
    document with the events, tokens/s per tenant, the streams digest, the
    predicted makespans and the SLO summary; every request finishes."""
    from repro_torch.launch import serve

    assert serve.main(["--fabric", "--arch", "minitron-4b", "--arch",
                       "falcon-mamba-7b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new-tokens", "6"]) == 0
    out = json.loads(capsys.readouterr().out)
    tenants = ["tenant0-minitron-4b", "tenant1-falcon-mamba-7b"]
    assert out["tenants"] == tenants and out["device"] == "cpu"
    assert set(out["tokens_per_s"]) == set(tenants)
    assert sum(out["tokens_emitted"].values()) == 2 * 3 * (6 - 1)
    assert len(out["streams_digest"]) == 64
    assert set(out["slo"]["tenants"]) == set(tenants)
    assert out["serving_captures"] == dict.fromkeys(tenants, 0)
    assert all({"step", "reason", "sizes"} <= set(e) for e in out["events"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "minitron-4b", "--arch", "falcon-mamba-7b"])


def test_slo_scheduler_preempts_and_reports_attainment():
    """A tenant whose head-of-line wait burns its TTFT budget gets a live
    stream preempted so the waiting request is admitted; preempted streams
    resume exactly (every request completes its budget, equal to a run
    with the scheduler off), and ``slo_attainment`` reports the targets."""
    def run(preempt):
        slo = fabric.SLOTarget(ttft_p99_ms=1e-3, per_token_p99_ms=1e-3)
        srv = ComposedServer([TenantSpec("a", "minitron-4b", slo=slo,
                                         serve=_sc(max_slots=1,
                                                   max_len=64))],
                             num_cus=2, device="cpu", policy=None,
                             slo_preempt=preempt)
        rng = np.random.default_rng(2)
        rids = [srv.submit("a", rng.integers(1, 200, size=6),
                           max_new_tokens=8) for _ in range(3)]
        out = srv.drain(max_steps=400)["a"]
        return srv, [out[r] for r in rids]

    srv, got = run(True)
    _, want = run(False)
    assert got == want and all(len(s) == 8 for s in got)
    att = srv.slo_attainment()
    assert att["slo_preemptions"] >= 1
    row = att["tenants"]["a"]
    assert row["preemptions"] >= 1 and row["ttft"]["n"] >= 3
    assert row["ttft"]["p99"]["target_ms"] == 1e-3
    assert row["ttft"]["p99"]["met"] is False


@pytest.mark.parametrize("scenario", ["mixed", "flash-crowd"])
def test_launcher_scenario_json_carries_reference_keys(capsys, scenario):
    """``--fabric --scenario`` over the reference's MIXED_FLEET on the CPU:
    one JSON document on stdout with the reference launcher's keys and a
    per-class throughput for each of the four classes."""
    from repro_torch.launch import serve

    assert serve.main(["--fabric", "--scenario", scenario, "--reduced",
                       "--device", "cpu", "--requests", "3",
                       "--max-new-tokens", "6", "--kv-frac", "0.4",
                       "--log-every", "0"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert {"scenario", "harness_step_ms", "slo_attainment",
            "per_class_throughput", "events", "streams_digest"} <= set(out)
    assert out["scenario"] == scenario
    tput = out["per_class_throughput"]
    assert sorted(v["class"] for v in tput.values()) == \
        ["decode", "encdec", "encoder", "ssm"]
    assert all(v["value"] > 0 for v in tput.values())
    assert tput["encoder-qwen2.5-32b"]["unit"] == "seqs_per_s"
    assert set(out["serving_captures"].values()) == {0}
    slo = out["slo_attainment"]["tenants"]
    assert (set(slo) == set(tput)) == (scenario == "flash-crowd")
    with pytest.raises(SystemExit):
        serve.main(["--scenario", scenario, "--device", "cpu"])


def test_launcher_slo_smoke_preempts_with_equal_digests(capsys):
    """``--slo-smoke --device cpu``: the flash crowd on the oversubscribed
    paged arena preempts, and the paged run's streams equal the
    slot-granular replay's."""
    from repro_torch.launch import serve

    assert serve.main(["--slo-smoke", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["ok"] and out["preemptions"] >= 1 and out["digest_match"]
    assert out["complete"] and len(out["attainment_tenants"]) == 4


def test_launcher_obs_smoke_traces_spans(capsys, tmp_path):
    """``--obs-smoke``: the trace holds recompose, decode-step and
    warm-compile spans, and every class has decode-step latencies."""
    from repro_torch.launch import serve

    trace = tmp_path / "trace.json"
    assert serve.main(["--obs-smoke", "--device", "cpu", "--trace-out",
                       str(trace)]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["ok"] and out["recompose_spans"] >= 1
    assert out["decode_step_spans"] >= 1 and out["warm_compile_spans"] >= 1
    assert set(out["decode_step_hist_by_class"]) == \
        {"decode", "ssm", "encoder", "encdec"}
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"recompose", "warm_compile"} <= names
