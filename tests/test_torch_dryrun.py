"""``repro_torch.launch.dryrun`` on the CPU: the step of every arch x cell
counted on ``meta`` tensors.

- ``main --all`` (the archs' reduced configs at the cells' full shapes,
  one module fixture) writes one JSON per cell of the 32, no ``.FAILED``;
  each has the reference's result fields on one card (mesh "single", 1
  chip, collectives 0), its peak and fit mark, the roofline terms on the
  H100 and ``model_flops_for``'s model FLOPs; a train cell's peak holds
  its state (params and grads in ``param_dtype``, AdamW's m and v in
  fp32: 16 bytes a parameter, 12 for arctic-480b's bf16 masters), and
  each cell counts the kernels its path launches.
- At full width, the train cells of qwen1.5-110b and arctic-480b (B 256 x
  S 4096) are marked as not fitting, above their state; a cell
  that is no ``CELLS_BY_NAME`` entry runs too.
- The grid resumes from its files, ``--force`` reruns, a failing cell
  leaves ``.FAILED`` with its traceback and exit 1, and the reference's
  mesh and impl knobs exit 2 naming their reason.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import cells_for as jax_cells_for  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.analysis import roofline as roof  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

CELLS = dryrun.cell_list()
# the kernels each kind of step launches, by the arch's mixer
ATTN = {"train": "flash_attention_lse", "prefill": "flash_attention",
        "decode": "ragged_decode"}
SCAN = {"train": "mamba_scan_train", "prefill": "mamba_scan",
        "decode": "mamba_step"}


def test_cell_list_is_the_reference_grid():
    want = [(a, c.name) for a in JAX_ARCH_IDS
            for c in jax_cells_for(jax_get_config(a))]
    assert sorted(CELLS) == sorted(want) and len(CELLS) == 32


def _train_bytes(cfg) -> int:
    """The train step's state a parameter: the master and its gradient in
    ``param_dtype`` (fp32: 4 + 4; arctic-480b's bf16: 2 + 2), AdamW's m
    and v in fp32."""
    es = 4 if cfg.param_dtype == "float32" else 2
    return (2 * es + 8) * cfg.param_count()


@pytest.fixture(scope="module")
def reduced_grid(tmp_path_factory):
    """``main(["--all"])`` over the reduced configs: {tag: result}."""
    out = tmp_path_factory.mktemp("dryrun")
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "get_config", get_reduced)
    try:
        assert dryrun.main(["--all", "--out", str(out)]) == 0
    finally:
        mp.undo()
    assert not list(out.glob("*.FAILED"))
    files = sorted(out.glob("*.json"))
    assert len(files) == 32
    return out, {p.stem: json.loads(p.read_text()) for p in files}


@pytest.mark.parametrize("arch,cell", CELLS)
def test_reduced_cell_result(reduced_grid, arch, cell):
    _, results = reduced_grid
    res = results[f"{arch}__{cell}__single__baseline"]
    cfg, shape = get_reduced(arch), dryrun.CELLS_BY_NAME[cell]
    assert (res["mesh"], res["chips"], res["kind"]) == ("single", 1,
                                                        shape.kind)
    assert res["collective_bytes_per_device"] == 0
    assert res["collective_by_kind"] == res["collective_count"] == {}
    peak = res["peak_bytes_per_device"]
    assert res["fits_hbm"] == (peak <= dryrun.FIT_BYTES)
    r = res["roofline"]
    assert r["compute_s"] == pytest.approx(
        res["hlo_flops_per_device"] / 989e12)
    assert r["memory_s"] == pytest.approx(
        res["hlo_bytes_per_device"] / 3.35e12)
    assert r["collective_s"] == 0 and r["dominant"] in ("compute", "memory")
    assert r["model_flops"] == roof.model_flops_for(cfg, shape)
    assert r["peak_memory_gib"] == pytest.approx(peak / 2**30)
    weights = 2 * cfg.param_count()                 # bf16 at serving
    assert peak >= (_train_bytes(cfg) if shape.kind == "train" else weights)
    if shape.kind == "train":       # 8 N T counted against 6 N T
        assert res["hlo_flops_per_device"] >= r["model_flops"]
    kernels = set(res["kernels"])
    # MLA's decode step is the absorbed einsum chain, outside any kernel
    if not cfg.attention_free and not (cfg.mla and shape.kind == "decode"):
        assert any(k.startswith(ATTN[shape.kind]) for k in kernels), kernels
    if cfg.ssm is not None:
        assert SCAN[shape.kind] in kernels, kernels


def test_grid_resumes_and_force_reruns(reduced_grid, monkeypatch, capsys):
    out, _ = reduced_grid
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    assert capsys.readouterr().out.count("[skip]") == 32
    assert dryrun.main(["--arch", "minitron-4b", "--cell", "decode_32k",
                        "--out", str(out), "--force"]) == 0
    assert "[ok  ] minitron-4b__decode_32k" in capsys.readouterr().out


def test_failed_cell_leaves_its_traceback(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    assert dryrun.main(["--arch", "hymba-1.5b", "--cell", "train_4k",
                        "--out", str(tmp_path)]) == 1
    failed = tmp_path / "hymba-1.5b__train_4k__single__baseline.FAILED"
    assert "no such step" in failed.read_text()
    assert "1 failures" in capsys.readouterr().out


@pytest.mark.parametrize("flags,reason", [
    (["--multi-pod"], "second GPU"), (["--no-sp"], "second GPU"),
    (["--moe-group", "64"], "second GPU"),
    (["--attn-impl", "triangular"], "skips the masked blocks"),
    (["--ssm-impl", "fused"], "one scan"), (["--attn-block", "256"], "tiles"),
])
def test_reference_knobs_exit_with_their_reason(flags, reason, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "minitron-4b", "--cell", "train_4k"] + flags)
    assert e.value.code == 2
    assert reason in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "arctic-480b"])
def test_full_width_train_cells_do_not_fit(arch):
    res = dryrun.run_cell(arch, "train_4k")
    cfg = get_config(arch)
    assert not res["fits_hbm"]
    assert res["peak_bytes_per_device"] >= _train_bytes(cfg)
    assert res["roofline"]["model_flops"] == 6.0 * \
        cfg.active_param_count() * 256 * 4096


def test_any_shape_cell_runs():
    """A cell of the shapes the card runs, not in ``CELLS_BY_NAME``:
    minitron-4b serving 8 slots of 2048 fits with its bf16 weights and
    KV cache."""
    cfg = get_config("minitron-4b")
    res = dryrun.run_cell("minitron-4b", ShapeCell("serve", 2048, 8,
                                                   "decode"))
    kv = 2 * cfg.num_layers * 8 * 2048 * cfg.num_kv_heads * \
        cfg.resolved_head_dim * 2
    assert res["fits_hbm"] and res["cell"] == "serve"
    assert 2 * cfg.param_count() + kv <= res["peak_bytes_per_device"] \
        <= 1.1 * (2 * cfg.param_count() + kv)
    assert res["kernels"]["ragged_decode"][0] == cfg.num_layers
