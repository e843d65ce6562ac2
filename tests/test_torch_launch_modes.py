"""The launcher's ``--scaling-curve``, ``--dse-smoke`` and ``--dp-bench``
on the CPU, against the reference launcher (``repro.launch.serve``).

1. ``--dse-smoke``: one subprocess with 8 fake host devices runs the
   reference's ``run_dse_smoke`` twice, as it ships (tensor-parallel
   engines) and on a replicated fabric (``ComposedServer(tp=False)``, the
   fabric the port's one card is: its Stage 1 runs with
   ``tp_allowed=False``).  The port's ``dse_smoke --reduced``, priced on
   the reference's per-chip numbers as one CU, must give the replicated
   run's ``design_points``, ``applied_deltas``, ``nondefault``,
   ``dp_picked``, ``complete`` and ``ok``.  The shipped run picks
   ``dp > 1``; the replicated one does not: there Stage 1 has no
   collective cost for replicas to avoid, so one engine on the grant
   prices no worse than ``dp`` slices.
2. ``--dp-bench``: Stage 1's chosen and forced points for the bench's
   design space equal the reference's, computed in process (no device);
   the port's bench at ``--scale-steps 2 --device cpu`` returns the
   reference's keys with chosen ``dp > 1`` and forced ``dp`` 1, both arms
   applied as priced, no capture in a timed window, and every request's
   stream equal across the arms.
3. ``--scaling-curve`` at ``--scale-steps 2 --device cpu``: the reference's
   keys, 4 slots per CU, sizes above ``--num-cus`` dropped, ``tp`` false.
4. The parser's new flags have the reference's defaults.

The module runs its port's runs on one torch thread, and the reference's
subprocess on one XLA thread: under a parallel test run, every worker's
threads spinning on the same cores slowed ``dp_bench`` from 3 s to 112 s
and the reference's subprocess from 40 s to over 150 s.  No compared field
depends on the thread count.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.common.platform import PlatformProfile  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serve import AnalyticalPolicy, TenantDesignSpace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the reference's per-chip TPU_V5E numbers as one CU of the port's policy
# (held to the reference's record in tests/test_torch_fabric_policy.py)
TPU_NUMBERS = PlatformProfile(
    name="tpu_v5e", peak_flops=197e12, atom_shape=(8, 128, 128),
    atom_cycles=8.0, compute_clock_hz=0.94e9, num_compute_units=4,
    hbm_bytes=16 << 30, hbm_bw=819e9, onchip_bytes=128 << 20,
    onchip_bw=22e12, ici_bw=50e9, ici_links=4, instr_bytes=32,
    reconfig_cycles=16.0, bitstream_reload_s=10.0)
DSE_FIELDS = ("design_points", "applied_deltas", "nondefault", "dp_picked",
              "complete", "ok")
# the keys of the reference launcher's documents
SCALING_KEYS = {"bench_model", "measured_steps", "tp", "slots_by_cus",
                "tokens_per_s_by_cus", "step_ms_by_cus", "monotone"}
DP_KEYS = {"bench_model", "grant_cus", "queue", "measured_steps",
           "timed_reps", "slot_cap", "chosen", "forced", "tokens_per_s_dp",
           "tokens_per_s_dp1", "speedup", "ok"}

_JAX_DSE_SMOKE = """
import os
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import sys
sys.path.insert(0, "src")
import contextlib
import functools
import io
import json
import repro.launch.serve as S

out = {}
shipped = S.ComposedServer
for name, cls in (("shipped", shipped),
                  ("replicated", functools.partial(shipped, tp=False))):
    S.ComposedServer = cls
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = S.main(["--dse-smoke"])
    doc = json.loads(next(line for line in buf.getvalue().splitlines()
                          if line.startswith("{")))
    out[name] = {"rc": rc, "doc": doc}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's port runs on one torch thread (see the top)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_dse_smoke():
    """The reference's ``--dse-smoke`` as shipped and on a replicated
    fabric, from one 8-fake-device subprocess (about 25 s)."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(
        _JAX_DSE_SMOKE)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-4000:])
    assert time.perf_counter() - t0 < 300
    return json.loads(run.stdout.strip().splitlines()[-1])


def _args(*argv):
    return serve.parser().parse_args(list(argv))


def test_dse_smoke_equals_reference_replicated_fabric(jax_dse_smoke):
    ref = jax_dse_smoke["replicated"]
    _, doc, submitted = serve.dse_smoke(
        _args("--dse-smoke", "--reduced", "--device", "cpu"),
        AnalyticalPolicy(TPU_NUMBERS))
    got = json.loads(json.dumps({k: doc[k] for k in DSE_FIELDS},
                                default=list))
    assert got == {k: ref["doc"][k] for k in DSE_FIELDS}
    assert ref["rc"] == 1 and not doc["ok"] and not doc["dp_picked"]
    assert doc["complete"] and doc["applied_deltas"] and doc["nondefault"]
    # every applied delta is Stage 1's pick; warming left nothing to capture
    assert doc["deltas_from_stage1"]
    assert len(doc["stage1_picks"]) == len(doc["events"]) >= 1
    assert doc["serving_captures"] == {"a": 0, "b": 0}
    assert [t for t, _, _ in submitted] == ["a"] * 16 + ["b"] * 6


def test_reference_dse_smoke_picks_dp_only_with_tensor_parallelism(
        jax_dse_smoke):
    shipped = jax_dse_smoke["shipped"]
    assert shipped["rc"] == 0 and shipped["doc"]["ok"]
    assert shipped["doc"]["dp_picked"]
    assert any(d["tp"] for d in shipped["doc"]["design_points"].values())
    assert not jax_dse_smoke["replicated"]["doc"]["dp_picked"]


def test_dse_smoke_launcher_and_layer_cut(capsys):
    """The CLI prints the document and exits as the reference does (1: no
    ``dp > 1`` on one card); ``--layers`` cuts a tenant; fewer than 4 CUs
    is refused with 2."""
    rc = serve.main(["--dse-smoke", "--reduced", "--device", "cpu",
                     "--layers", "qwen2.5-32b=1"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == (0 if doc["ok"] else 1)
    assert doc["layers"]["b"] == 1 and doc["complete"]
    assert doc["tenants"] == {"a": "minitron-4b", "b": "qwen2.5-32b"}
    assert serve.main(["--dse-smoke", "--device", "cpu",
                       "--num-cus", "2"]) == 2
    with pytest.raises(ValueError):
        serve.dse_smoke(_args("--device", "cpu", "--num-cus", "3"))


def test_dp_bench_stage1_points_equal_reference():
    """The bench's design space (the reference's: tensor parallelism
    priced) on the reference's numbers: the same chosen and forced
    points, costs included."""
    from repro.launch import serve as jserve
    from repro.serve import AnalyticalPolicy as JPolicy
    from repro.serve import TenantDesignSpace as JSpace

    tcfg, jcfg = serve.bench_config(512, 6, 4096), \
        jserve.bench_config(512, 6, 4096)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tpol, jpol = AnalyticalPolicy(TPU_NUMBERS), JPolicy()
    for dp_cap in (64, 1):
        kw = dict(wclass="decode", max_len=4096, base_slots=4, slot_cap=4,
                  dp_cap=dp_cap)
        t = tpol.stage1.best(tcfg, TenantDesignSpace(**kw), 16, 4)
        j = jpol.stage1.best(jcfg, JSpace(**kw), 16, 4)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert (t.dp > 1) == (dp_cap > 1)


def test_dp_bench_on_cpu():
    doc, results = serve.dp_bench(
        _args("--dp-bench", "--scale-steps", "2", "--device", "cpu"),
        AnalyticalPolicy(TPU_NUMBERS))
    assert DP_KEYS <= set(doc) and doc["tp"] is False
    assert doc["chosen"]["dp"] > 1 and doc["forced"]["dp"] == 1
    assert doc["applied_dp"] == {"dp": doc["chosen"]["dp"], "dp1": 1}
    assert doc["chosen"]["slots"] == doc["forced"]["slots"] == 4
    assert (doc["grant_cus"], doc["queue"], doc["slot_cap"]) == (4, 16, 4)
    assert doc["captures_in_windows"] == {"dp": 0, "dp1": 0}
    assert doc["tokens_per_s_dp"] > 0 and doc["tokens_per_s_dp1"] > 0
    assert doc["ok"] == (doc["tokens_per_s_dp"] > doc["tokens_per_s_dp1"])
    # the same 16 requests complete with the same streams in both arms
    assert sorted(results["dp"]) == sorted(results["dp1"]) == list(range(16))
    assert all(len(v) == 3 * 2 + 8 for v in results["dp"].values())
    assert results["dp"] == results["dp1"]
    assert doc["complete"] and doc["streams_equal"]


def test_scaling_curve_on_cpu(capsys):
    assert serve.main(["--scaling-curve", "--scale-steps", "2", "--device",
                       "cpu", "--num-cus", "2", "--scale-sizes", "1", "2",
                       "4", "--scale-dmodel", "512", "--scale-dff",
                       "2048"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert SCALING_KEYS <= set(doc) and doc["tp"] is False
    assert doc["slots_by_cus"] == {"1": 4, "2": 8}      # 4 dropped
    assert set(doc["tokens_per_s_by_cus"]) == {"1", "2"}
    assert all(v > 0 for v in doc["tokens_per_s_by_cus"].values())
    assert all({"p50", "p95"} <= set(v)
               for v in doc["step_ms_by_cus"].values())
    assert doc["captures_in_windows"] == {"1": 0, "2": 0}
    assert doc["bench_model"] == "serve-bench-d512-L4"


def test_scaling_curve_default_bench_model():
    doc = serve.scaling_curve(_args("--scaling-curve", "--scale-steps", "2",
                                    "--device", "cpu"))
    assert doc["bench_model"] == "serve-bench-d2048-L4"
    assert doc["slots_by_cus"] == {"1": 4, "2": 8, "4": 16}
    assert doc["captures_in_windows"] == {"1": 0, "2": 0, "4": 0}


@pytest.mark.parametrize("flags", [["--scaling-curve"], ["--dse-smoke"],
                                   ["--dp-bench"]])
def test_parser_defaults_equal_reference(monkeypatch, flags):
    """The reference's parsed arguments, caught at its mode's dispatch."""
    from repro.launch import serve as jserve

    seen = {}
    for fn in ("run_scaling", "run_dse_smoke", "run_dp_bench"):
        monkeypatch.setattr(jserve, fn,
                            lambda args: seen.setdefault("args", args) and 0)
    assert jserve.main(flags) == 0
    ref, got = vars(seen["args"]), vars(serve.parser().parse_args(flags))
    for key in ("scaling_curve", "scale_sizes", "scale_steps",
                "scale_slots_per_cu", "scale_dmodel", "scale_layers",
                "scale_dff", "dse_smoke", "dp_bench", "max_len", "seed",
                "reduced"):
        assert got[key] == ref[key], key
