"""The port's shape cells, ``core.gpu_modes``, the arena's device ops and
the two launch examples, on the CPU.

1. ``configs``: the four shape cells, ``CELLS_BY_NAME`` and ``cells_for``
   of every registered arch equal the reference's.
2. ``gpu_modes.arch_workload`` equals ``repro.core.tpu_modes``'s, MMLayer
   by MMLayer, for every registered arch x cell; ``dse_for_arch`` on the
   reference's accelerator and platform numbers (passed in) gives the
   reference's tiles, plan and makespan (the DSE modules are copies, so
   equal, not close).
3. On ``h100_accel``: the reference's checks of its TPU-profile DSE
   (``tests/test_perf_variants.py``) as cases: a valid schedule, at least
   two distinct tiles, an acyclic DAG; and the composed card prices at
   H100_SXM's peak within the 128 of 132 SMs that 8 CUs of 16 SMs use.
4. ``core.arena``: ``store_view``/``load_view``/``load_padded`` on a torch
   buffer round-trip and pad as the JAX functions do
   (``tests/test_arena.py``).
5. ``launch.quickstart`` and ``launch.multi_tenant_serve`` exit 0 with
   ``--device cpu`` (each asserts its own phases).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.common.platform import TPU_V5E  # noqa: E402
from repro.core import arena as jar  # noqa: E402
from repro.core import tpu_modes as jtm  # noqa: E402
from repro.core.schedule import validate as jvalidate  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.common.platform import H100_SXM, PlatformProfile  # noqa: E402
from repro_torch.core import arena as tar  # noqa: E402
from repro_torch.core import gpu_modes as tgm  # noqa: E402
from repro_torch.core.analytical import AccelConfig, layer_latency  # noqa: E402
from repro_torch.core.schedule import validate  # noqa: E402
from repro_torch.launch import multi_tenant_serve, quickstart  # noqa: E402

CELLS = [c.name for c in jcfg.ALL_CELLS]


def test_cells_equal_reference():
    assert [dataclasses.asdict(c) for c in tcfg.ALL_CELLS] == \
        [dataclasses.asdict(c) for c in jcfg.ALL_CELLS]
    assert {n: dataclasses.asdict(c) for n, c in tcfg.CELLS_BY_NAME.items()} \
        == {n: dataclasses.asdict(c) for n, c in jcfg.CELLS_BY_NAME.items()}
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(tcfg, name)) == \
            dataclasses.asdict(getattr(jcfg, name))


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_cells_for_equal_reference(arch):
    for get in ("get_config", "get_reduced"):
        t, j = getattr(tcfg, get)(arch), getattr(jcfg, get)(arch)
        assert t.supports_long_context == j.supports_long_context
        assert [c.name for c in tcfg.cells_for(t)] == \
            [c.name for c in jcfg.cells_for(j)]


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
@pytest.mark.parametrize("cell", CELLS)
def test_arch_workload_equals_reference(arch, cell):
    t = tgm.arch_workload(tcfg.get_config(arch), tcfg.CELLS_BY_NAME[cell])
    j = jtm.arch_workload(jcfg.get_config(arch), jcfg.CELLS_BY_NAME[cell])
    assert t.name == j.name
    assert [dataclasses.astuple(x) for x in t.layers] == \
        [dataclasses.astuple(x) for x in j.layers]
    # a stack of layers and an explicit token count too
    t3 = tgm.arch_workload(tcfg.get_config(arch), tcfg.CELLS_BY_NAME[cell],
                           layers=3, tokens_per_device=40)
    j3 = jtm.arch_workload(jcfg.get_config(arch), jcfg.CELLS_BY_NAME[cell],
                           layers=3, tokens_per_device=40)
    assert [dataclasses.astuple(x) for x in t3.layers] == \
        [dataclasses.astuple(x) for x in j3.layers]


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-v2-lite-16b",
                                  "falcon-mamba-7b"])
def test_dse_for_arch_equals_reference_on_its_numbers(arch):
    """The reference's chip as the port's accelerator and platform: the
    same plan (tiles, modes, placements) and makespan."""
    accel = AccelConfig(**dataclasses.asdict(jtm.tpu_accel()))
    platform = PlatformProfile(**dataclasses.asdict(TPU_V5E))
    t = tgm.dse_for_arch(tcfg.get_config(arch), tcfg.TRAIN_4K,
                         platform=platform, accel=accel, seed=0)
    j = jtm.dse_for_arch(jcfg.get_config(arch), jcfg.TRAIN_4K, seed=0)
    validate(t.problem, t.schedule)
    jvalidate(j.problem, j.schedule)
    fields = ("layer", "mkn", "tile", "mode_fmus", "mode_cus", "start",
              "end", "fmu_ids", "cu_ids")
    assert [tuple(getattr(p, f) for f in fields) for p in t.plan.layers] == \
        [tuple(getattr(p, f) for f in fields) for p in j.plan.layers]
    assert t.makespan == j.makespan


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-v2-lite-16b",
                                  "falcon-mamba-7b", "arctic-480b"])
def test_arch_workload_is_an_acyclic_dag(arch):
    wl = tgm.arch_workload(tcfg.get_config(arch), tcfg.TRAIN_4K)
    assert len(wl.layers) >= 2
    assert wl.total_flops > 0
    for i, layer in enumerate(wl.layers):
        assert all(d < i for d in layer.deps)


def test_dse_for_arch_on_h100_is_valid_and_diverse():
    res = tgm.dse_for_arch(tcfg.get_config("qwen2.5-32b"), tcfg.TRAIN_4K,
                           seed=0)
    validate(res.problem, res.schedule)
    assert res.makespan > 0
    # diverse layer shapes select more than one distinct tile
    assert len({pl.tile for pl in res.plan.layers}) >= 2


@pytest.mark.parametrize("num_cus", [8, 4, 2, 1])
def test_h100_accel_prices_at_the_card_peak(num_cus):
    """CUs x SMs per CU engines of one wgmma atom per 128 clocks: the
    composed card's peak is H100_SXM's, less the SMs an integer split of
    132 leaves idle (4 of 132 at 8 CUs); its FMUs hold that share of the
    shared memory."""
    accel = tgm.h100_accel(num_cus)
    p = H100_SXM
    sms = accel.num_cus * accel.aies_per_cu
    peak = sms * p.atom_flops * p.compute_clock_hz / p.atom_cycles
    assert sms == num_cus * (132 // num_cus) and sms <= 132
    assert peak == pytest.approx(p.peak_flops * sms / 132, rel=2e-3)
    if num_cus == 8:
        assert peak / p.peak_flops == pytest.approx(128 / 132, rel=2e-3)
    assert accel.onchip_elems * 4 <= 0.75 * p.onchip_bytes
    assert accel.num_fmus == 2 * num_cus
    # a large product on the whole composition runs at that peak
    m = k = n = 8192
    lb = layer_latency(accel, p, m, k, n)
    assert lb.compute_s >= 2 * m * k * n / peak
    assert lb.compute_s <= 1.01 * 2 * m * k * n / peak


def test_arena_device_ops_equal_jax():
    ja, ta = jar.FlexArena(capacity=4096), tar.FlexArena(capacity=4096)
    jbuf = jnp.zeros(4096, jnp.float32)
    tbuf = torch.zeros(4096, dtype=torch.float32)
    views = []
    for rows, cols, sign in ((16, 32, 1.0), (8, 64, -1.0), (5, 7, 0.5)):
        jv, tv = ja.alloc(rows, cols), ta.alloc(rows, cols)
        assert (tv.offset, tv.rows, tv.cols) == (jv.offset, jv.rows, jv.cols)
        m = sign * np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
        jbuf = jar.store_view(jbuf, jv, jnp.asarray(m))
        out = tar.store_view(tbuf, tv, torch.from_numpy(m))
        assert out is tbuf                       # written in place
        views.append((jv, tv, m))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    for jv, tv, m in views:
        np.testing.assert_array_equal(tar.load_view(tbuf, tv).numpy(), m)
        np.testing.assert_array_equal(tar.load_view(tbuf, tv).numpy(),
                                      np.asarray(jar.load_view(jbuf, jv)))
        padded = tar.load_padded(tbuf, tv, (64, 64))
        assert tuple(padded.shape) == (64, 64)
        np.testing.assert_array_equal(
            padded.numpy(), np.asarray(jar.load_padded(jbuf, jv, (64, 64))))
        assert float(padded[tv.rows:].abs().sum()) == 0.0
        assert float(padded[:, tv.cols:].abs().sum()) == 0.0
    # a store casts to the buffer's dtype, as the JAX function does
    jv, tv, _ = views[0]
    m = np.full((16, 32), 2.5, np.float64)
    tar.store_view(tbuf, tv, torch.from_numpy(m))
    jbuf = jar.store_view(jbuf, jv, jnp.asarray(m, jnp.float32))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))


@pytest.mark.parametrize("example", [quickstart, multi_tenant_serve],
                         ids=["quickstart", "multi_tenant_serve"])
def test_launch_example_runs_on_cpu(example, capsys):
    assert example.main(["--device", "cpu"]) == 0
    assert " OK" in capsys.readouterr().out
