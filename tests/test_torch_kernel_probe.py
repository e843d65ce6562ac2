"""The kernel probe's machinery on the CPU: which kernels a model's path
runs, the swap of a kernel's call site to its plain version and back, and
the rounding probe's paths on hymba-reduced, which all agree here because
every wrapper takes its plain version on a CPU tensor."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as ms  # noqa: E402
from repro_torch.launch import kernel_probe as kp  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

ALL = ["flash_attention", "ragged_decode", "mamba_step", "mamba_scan"]


@pytest.mark.parametrize("arch,want", [
    ("granite-34b", ALL[:2]), ("minitron-4b", ALL[:2]),
    ("falcon-mamba-7b", ALL[2:]), ("hymba-1.5b", ALL)])
def test_model_kernels(arch, want):
    assert kp.model_kernels(get_reduced(arch)) == want


def test_plain_swaps_each_call_site_and_restores_it():
    sites = {"flash_attention": (A, "flash_attention"),
             "ragged_decode": (A, "ragged_decode_attention"),
             "mamba_step": (ms, "mamba_step"),
             "mamba_scan": (ms, "mamba_scan")}
    before = {k: getattr(m, a) for k, (m, a) in sites.items()}
    for name in ALL:
        with kp.plain([name]):
            for k, (m, a) in sites.items():
                assert (getattr(m, a) is before[k]) == (k != name)
    with pytest.raises(RuntimeError):
        with kp.plain(ALL):
            raise RuntimeError("restored all the same")
    assert {k: getattr(m, a) for k, (m, a) in sites.items()} == before


def test_rounding_paths_put_each_kernel_off_and_alone():
    paths = kp.rounding_paths(ALL)
    assert paths["kernels"] == (True, ())
    assert paths["plain path"] == (False, ())
    for k in ALL:
        assert paths[f"all but {k}"] == (True, (k,))
        assert k not in paths[f"{k} alone"][1]
        assert len(paths[f"{k} alone"][1]) == 3
    assert len(paths) == 3 + 2 * len(ALL)


def test_rounding_probe_on_cpu_agrees_on_every_path():
    res = kp.rounding("hymba-1.5b", [1], 12, torch.device("cpu"),
                      reduced=True)
    paths = res[1]
    floor = paths["plain path"]["largest"]
    assert 0 < floor < 0.1
    assert floor == max(paths["plain path"]["from_fp32"])
    for name, r in paths.items():
        assert len(r["from_fp32"]) == len(r["from_plain"]) == kp.STEPS + 1
        assert r["largest"] == pytest.approx(floor, rel=1e-6), name
        assert r["ratio"] == pytest.approx(1.0, rel=1e-6), name
        assert max(r["from_plain"]) <= 1e-6 * floor, name


def test_ragged_splits_needs_a_card():
    with pytest.raises(ValueError):
        kp.ragged_splits(torch.device("cpu"))


def test_scan_clusters_needs_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        kp.scan_clusters(torch.device("cpu"))


def test_train_spread_needs_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        kp.train_spread("falcon-mamba-7b", 3e-4, torch.device("cpu"))


def test_collectives_probe_runs_each_in_a_world_of_its_own(monkeypatch):
    """The probe's machinery with host tensors: each collective in its own
    world of gloo ranks, a rank's failure reported and not raised."""
    monkeypatch.setattr(kp, "COLLECTIVES", ("dtensor_all_gather",
                                            "nothing"))
    got = kp.collectives(torch.device("cpu"))
    assert got["dtensor_all_gather"] == "ok"
    assert "no collective nothing" in got["nothing"]
