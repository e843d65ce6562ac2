"""The port's sharded train step for the SSM and hybrid families against
the reference's, on the CPU.  The reference (``make_train_step`` on 8
fake JAX devices, ``tests/_torch_train_mesh_ref.py``) and the port
(``Trainer`` on a gloo world of 8 CPU ranks,
``tests/_torch_train_mesh_worker.py``) run once per module, side by side
once the reference has written its initial parameters and batches
(``tests/_torch_train_mesh_runs.py``).

- falcon-mamba-7b and hymba-1.5b, reduced, on a (2 data, 4 model) mesh
  with ``train_rules(sequence_parallel=False)`` and ``True``, two steps
  from the reference's initial parameters (the schedule's lr is 0 at step
  0): in fp32 the loss within 1e-5 relative and every parameter within
  1e-5 of both the reference's sharded step and the port's single-device
  step; in bf16 (sequence parallelism on) within the reference test's own
  5e-2.  The Mamba scan runs on each rank's own rows and channels
  (``partitioning.channel_local``), its dB and dC summed over the model
  dim, its dA_log and dD over the data dim.
- ``Trainer.fit`` on the mesh for falcon-mamba-reduced from
  ``setup_sharded_state``, each rank's pipeline giving its rows, against
  ``Trainer.fit`` on one device: losses and parameters within 1e-5.
- The scan's plain pair through ``channel_local`` on a (2, 4) and a (1, 8)
  mesh against the whole call: y, dx and ddt bitwise (per channel and
  row); dA_log and dD (per channel, summed over rows: the CPU's reduction
  picks its order by the tensor's width) and dB, dC (summed over channels
  across ranks) within 1e-6 of each gradient's largest value.  A DTensor
  reaching ``SelectiveScanFn`` raises.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_mesh_runs import (close, flat, max_diff,  # noqa: E402
                                    port_tree, run_both)

LOSS_FP32_TOL = 1e-5
PARAM_FP32_TOL = 1e-5
BF16_TOL = 5e-2              # the reference test's own
SCAN_SUM_TOL = 1e-6
ARCHS = ("falcon-mamba-7b", "hymba-1.5b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(init, reference, port): each side's results, one run each."""
    return run_both("ssm", tmp_path_factory.mktemp("mesh_ssm"))


@pytest.mark.parametrize("sp", [False, True], ids=["dp_tp", "seq_par"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_fp32_matches_reference_and_single_device(runs, arch,
                                                               sp):
    _, ref, port = runs
    losses, params = port[(arch, "float32", sp)]
    ref_losses, ref_params = ref[(arch, "float32", sp)]
    close(losses, ref_losses, LOSS_FP32_TOL, rel=True)
    got = flat(params)
    errs = max_diff(got, port_tree(ref_params, arch))
    assert max(errs.values()) <= PARAM_FP32_TOL, errs
    one_losses, one = port[(arch, "float32", "single")]
    close(losses, one_losses, LOSS_FP32_TOL, rel=True)
    errs = max_diff(got, flat(one))
    assert max(errs.values()) <= PARAM_FP32_TOL, errs
    assert losses[0] != losses[1]            # the second step moved


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_bf16_within_reference_tolerance(runs, arch):
    _, ref, port = runs
    losses, params = port[(arch, "bfloat16", True)]
    ref_losses, ref_params = ref[(arch, "bfloat16", True)]
    close(losses, ref_losses, BF16_TOL, rel=False)
    got = flat(params)
    errs = max_diff(got, port_tree(ref_params, arch))
    assert max(errs.values()) <= BF16_TOL, errs
    one_losses, one = port[(arch, "bfloat16", "single")]
    close(losses, one_losses, BF16_TOL, rel=False)
    assert max(max_diff(got, flat(one)).values()) <= BF16_TOL


def test_trainer_fit_on_mesh_equals_one_device(runs):
    _, _, port = runs
    losses, params, (host_id, num_hosts) = port["fit_mesh"]
    one_losses, one = port["fit_single"]
    assert num_hosts == 2 and len(losses) == 3
    close(losses, one_losses, LOSS_FP32_TOL, rel=True)
    assert max(max_diff(flat(params), flat(one)).values()) <= PARAM_FP32_TOL


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
def test_channel_local_scan_matches_whole_call(runs, shape):
    _, _, port = runs
    got = port["scan_local"][shape]
    assert got["y"] == 0.0
    dx, ddt, db, dc, da_log, dd = got["grads"]
    assert dx == 0.0 and ddt == 0.0
    assert max(db, dc, da_log, dd) <= SCAN_SUM_TOL, got["grads"]


def test_channel_local_runs_each_rank_on_its_rows_and_channels(runs):
    _, _, port = runs
    got = port["scan_local"]
    # rank 0: (2, 4) mesh -> 2 of 4 rows, 8 of 32 channels; (1, 8): 4 of 32
    # placements by mesh dim: the tensor dim each splits
    assert got[(2, 4)]["y_place"] == [0, 2]
    assert got[(1, 8)]["y_place"] == [0, 2]
    assert got[(2, 4)]["local_shapes"] == [
        (2, 40, 8), (2, 40, 8), (2, 40, 8), (2, 40, 8), (8, 8), (8,)]
    assert got[(1, 8)]["local_shapes"] == [
        (4, 40, 4), (4, 40, 4), (4, 40, 8), (4, 40, 8), (4, 8), (4,)]


def test_dtensor_reaching_selective_scan_raises(runs):
    _, _, port = runs
    assert port["scan_local"]["raises"] is not None
    assert "channel_local" in port["scan_local"]["raises"]
