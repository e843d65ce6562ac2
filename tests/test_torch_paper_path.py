"""The port's paper path against the JAX package, module by module, on the
CPU: two-stage DSE plans, Table-1 instruction streams (byte for byte, and
read back across the packages), the data-plane simulator's DDR, and the
whole slice through ``repro_torch.launch.dse_to_silicon``.

The DSE, codegen and ISA modules are framework-free copies, so their
results must be equal, not close.  The simulators both compute in fp32:
the port's DDR must lie within 1e-5 of the JAX numpy simulator's
(summation order only, O(1) values).
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_workloads as jwl  # noqa: E402
from repro.core import codegen as jcg  # noqa: E402
from repro.core import instructions as jisa  # noqa: E402
from repro.core.analytical import filco_vck190 as j_accel  # noqa: E402
from repro.core.dse import run_dse as j_run_dse  # noqa: E402
from repro.core.ga import GAConfig as JGAConfig  # noqa: E402
from repro.core.simulator import DataPlaneSim as JSim  # noqa: E402
from repro_torch.configs import paper_workloads as twl  # noqa: E402
from repro_torch.core import codegen as tcg  # noqa: E402
from repro_torch.core import instructions as tisa  # noqa: E402
from repro_torch.core.analytical import filco_vck190 as t_accel  # noqa: E402
from repro_torch.core.dse import run_dse as t_run_dse  # noqa: E402
from repro_torch.core.ga import GAConfig as TGAConfig  # noqa: E402
from repro_torch.core.simulator import DataPlaneSim as TSim  # noqa: E402
from repro_torch.kernels.filco_mm import ops as fm  # noqa: E402
from repro_torch.launch import dse_to_silicon as launch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PLAN_FIELDS = ("layer", "mkn", "tile", "fmu_ids", "cu_ids", "start", "end")
# name -> builder over a package's paper_workloads module: the same
# workload from each package
WORKLOADS = {
    "MLP-S": lambda p: p.MLP_S,
    "PointNet-S": lambda p: p.POINTNET_S,
    "BERT-32/L1": lambda p: p.bert(32, layers=1, name="BERT-32/L1"),
}


def _dse(build, *, seed=0, solver="ga", max_modes=4):
    jw, tw = build(jwl), build(twl)
    jr = j_run_dse(jw, j_accel(), solver=solver, max_modes=max_modes,
                   ga_config=JGAConfig(population=16, generations=12,
                                       seed=seed))
    tr = t_run_dse(tw, t_accel(), solver=solver, max_modes=max_modes,
                   ga_config=TGAConfig(population=16, generations=12,
                                       seed=seed))
    return jw, tw, jr, tr


def _plan(res):
    return [tuple(getattr(pl, f) for f in PLAN_FIELDS)
            for pl in res.plan.layers]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_dse_plans_equal(name, seed):
    _, _, jr, tr = _dse(WORKLOADS[name], seed=seed)
    assert _plan(tr) == _plan(jr)
    assert tr.makespan == jr.makespan and tr.plan.makespan == jr.plan.makespan
    assert tr.solver == jr.solver == "ga"


def test_dse_exact_solver_plans_equal():
    """The B&B proves optimality on MLP-S in both packages, so no time
    limit decides the plan."""
    _, _, jr, tr = _dse(WORKLOADS["MLP-S"], solver="milp")
    assert jr.optimal and tr.optimal
    assert _plan(tr) == _plan(jr) and tr.makespan == jr.makespan


def _streams(isa, prog):
    out = {"gen": prog.gen, "iom_load": prog.iom_load,
           "iom_store": prog.iom_store}
    out.update({("fmu", u): s for u, s in prog.fmu.items()})
    out.update({("cu", u): s for u, s in prog.cu.items()})
    return {key: isa.encode_stream(s) for key, s in out.items()}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_codegen_streams_byte_equal_and_cross_decode(name):
    jw, tw, jr, tr = _dse(WORKLOADS[name])
    jp, tp = jcg.generate(jw, jr.plan), tcg.generate(tw, tr.plan)
    jb, tb = _streams(jisa, jp), _streams(tisa, tp)
    assert tb == jb
    assert dataclasses.astuple(tp.layout) == dataclasses.astuple(jp.layout)
    assert tp.total_bytes() == jp.total_bytes()
    # the binary format carries programs between the packages
    own = {"gen": tp.gen, "iom_load": tp.iom_load, "iom_store": tp.iom_store}
    own.update({("fmu", u): s for u, s in tp.fmu.items()})
    own.update({("cu", u): s for u, s in tp.cu.items()})
    for key, data in jb.items():
        kind = key if isinstance(key, str) else key[0]
        assert tisa.decode_stream(kind, data) == own[key], key


def _sims(build, *, seed=0, use_kernel=False):
    """Both simulators from the same numpy DDR image, run."""
    jw, tw, jr, tr = _dse(build, seed=seed)
    jp, tp = jcg.generate(jw, jr.plan), tcg.generate(tw, tr.plan)
    layout = tp.layout
    cap = max(max(l.m * l.k, l.k * l.n, l.m * l.n) for l in tw.layers)
    accel = t_accel()
    image = launch.ddr_image(tw, layout, seed)
    jsim = JSim(layout.total_elems, accel.num_fmus, cap, accel.num_cus,
                use_kernel=use_kernel)
    jsim.ddr[:] = image
    tsim = TSim(layout.total_elems, accel.num_fmus, cap, accel.num_cus,
                device="cpu")
    tsim.ddr.copy_(torch.from_numpy(image))
    before = fm.launches
    jsim.run(jp)
    tsim.run(tp)
    assert fm.launches == before          # CPU tensors: the plain version
    return tw, tp, jsim, tsim, image


def _walk_errors(tw, tp, ddr, image):
    outs = launch.reference_walk(tw, tp.layout, torch.from_numpy(image))
    return launch.layer_errors(tw, tp.layout, ddr, outs)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_simulator_ddr_matches_jax_simulator(name):
    tw, tp, jsim, tsim, image = _sims(WORKLOADS[name])
    np.testing.assert_allclose(tsim.ddr.numpy(), jsim.ddr, rtol=1e-5,
                               atol=1e-5)
    assert _walk_errors(tw, tp, tsim.ddr, image).max() <= launch.REL_TOL


def test_simulator_multi_cu_row_split_matches_jax():
    """A layer on more than one CU splits its rows; both simulators agree
    and reproduce A @ B."""
    tw, tp, jsim, tsim, image = _sims(lambda p: p.mlp(64, 48, 1, "one"),
                                      seed=3)
    assert len(tp.layer_programs[0].cu_work) > 1
    np.testing.assert_allclose(tsim.ddr.numpy(), jsim.ddr, rtol=1e-5,
                               atol=1e-5)
    assert _walk_errors(tw, tp, tsim.ddr, image).max() <= launch.REL_TOL


def test_simulator_matches_jax_simulator_through_flex_mm_kernel():
    """The JAX simulator's CU path through the interpret-mode Pallas
    kernel against the port's plain path."""
    _, _, jsim, tsim, _ = _sims(lambda p: p.mlp(24, 40, 3, "tiny"),
                                use_kernel=True)
    np.testing.assert_allclose(tsim.ddr.numpy(), jsim.ddr, rtol=1e-5,
                               atol=1e-5)


def test_simulator_without_a_device_wants_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSim(16, 2, 8, 1)


def test_slice_end_to_end_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dse_to_silicon",
         "--workload", "BERT-32/L1", "--device", "cpu"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["ok"] and stats["device"] == "cpu"
    assert stats["layers"] == 8 and stats["cu_passes"] > 8
    assert stats["max_rel_err"] <= launch.REL_TOL
