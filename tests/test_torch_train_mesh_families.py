"""The port's sharded train step for the MoE/MLA, enc-dec and Adafactor
configurations against the reference's, on the CPU, and Adafactor on a
mesh.  The reference (``make_train_step`` on 8 fake JAX devices,
``tests/_torch_train_mesh_ref.py``) and the port (``Trainer`` on a gloo
world of 8 CPU ranks, ``tests/_torch_train_mesh_worker.py``) run once per
module, side by side once the reference has written its initial
parameters and batches (``tests/_torch_train_mesh_runs.py``).

- deepseek-v2-lite-16b (MLA, MoE with a dense prologue layer),
  seamless-m4t-medium (frames from ``batch_with_frames``, the
  bidirectional encoder, cross-attention), arctic-480b (MoE with its
  dense residual; AdamW) and qwen1.5-110b with Adafactor, reduced, on a
  (2 data, 4 model) mesh with ``train_rules(sequence_parallel=False)``
  and ``True``, two steps: the loss within 1e-5 relative and every
  parameter within 1e-5 of both the reference's sharded step and the
  port's single-device step, in fp32.
- Adafactor's statistics on the mesh: each laid out as its parameter's
  stacked leaf less the dim it averages over; one update at lr 1 on drawn
  gradients within 1e-6 of the single-device update (relative to the
  largest update), and the state after the two steps within 1e-6 of the
  single-device state.
- The elastic reshard of an Adafactor state: saved on (2, 4), restored
  onto (4, 2) and onto one device, bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_mesh_runs import (close, flat, max_diff,  # noqa: E402
                                    port_tree, run_both)

LOSS_FP32_TOL = 1e-5
PARAM_FP32_TOL = 1e-5
UPDATE_TOL = 1e-6
ARCHS = ("deepseek-v2-lite-16b", "seamless-m4t-medium", "arctic-480b",
         "qwen1.5-110b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(init, reference, port): each side's results, one run each."""
    return run_both("families", tmp_path_factory.mktemp("mesh_families"))


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


def test_optimizers_are_each_configs_own(runs):
    init, _, _ = runs
    assert init["qwen1.5-110b"]["optimizer"] == "adafactor"
    assert init["arctic-480b"]["optimizer"] == "adamw"
    assert init["deepseek-v2-lite-16b"]["optimizer"] == "adamw"


def _stat_place(place, ndim, stacked):
    """The expected (vr, vc) placements, by mesh dim the tensor dim it
    splits (None: whole): the parameter's, one dim on for a stacked leaf,
    each statistic less the dim it averages over."""
    def drop(gone):
        out = []
        for d in place:
            d = None if d is None else d + int(stacked)
            out.append(None if d is None or d == gone else d - int(d > gone))
        return out
    return drop(ndim - 1), drop(ndim - 2)


def test_adafactor_state_placements(runs):
    _, _, port = runs
    got = port["ada_placements"]
    # embed (V, d): vocab on model, embed on data; vr (V,) averages over
    # d, vc (d,) over V
    # (placements by mesh dim: the tensor dim each splits, None whole)
    place, stats = got["embed"]
    assert place == [1, 0]
    assert stats["vr"] == ([None, 0], (256,))
    assert stats["vc"] == ([0, None], (64,))
    factored = 0
    for name, (place, stats) in got.items():
        stacked = ".layers." in name
        if "v" in stats:
            assert stats["v"][0] == place, name
            continue
        ndim = len(stats["vr"][1]) + 1
        vr, vc = _stat_place(place, ndim, stacked)
        assert stats["vr"][0] == vr and stats["vc"][0] == vc, name
        factored += 1
    assert factored >= 10


def test_adafactor_update_on_mesh_matches_one_device(runs):
    _, _, port = runs
    assert port["ada_update"] <= UPDATE_TOL
    assert port["ada_state"] <= UPDATE_TOL


def test_adafactor_state_after_steps_matches_one_device(runs):
    _, _, port = runs
    got = flat(port[("qwen1.5-110b", "opt")])
    want = flat(port[("qwen1.5-110b", "opt", "single")])
    assert max(max_diff(got, want).values()) <= UPDATE_TOL


@pytest.mark.parametrize("target", ["mesh_4x2", "one_device"])
def test_adafactor_elastic_reshard(runs, target):
    _, _, port = runs
    if target == "one_device":
        assert port["ada_elastic_single"]
        return
    got = port["ada_elastic_mesh"]
    assert got["equal"]
    assert got["local"] == [(64,), (128,)]   # vocab over 4, then over 2
