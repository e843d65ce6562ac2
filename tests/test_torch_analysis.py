"""The port's analysis layer against the reference's on the CPU.

- ``active_param_count`` and ``model_flops_for`` equal the reference's for
  every arch and every arch x cell of ``cells_for`` (exact).
- ``derive_terms`` on ``H100_SXM`` gives the terms worked out by hand from
  the profile; one card has no collective term.
- ``kernel_bound`` and the kernels' work formulas reproduce three rows of
  ``PERF.md``'s kernel table.
- ``opcount`` on the programs of ``tests/test_hlo_analysis.py`` equals the
  reference's ``analyze_hlo`` of the same ``jnp`` programs in FLOPs
  (exact), a Python loop standing for ``lax.scan``; the 256^2 matmul's
  bytes are 3 x 256^2 x 4, inside the reference test's range.
- The reduced minitron decode step and prefill (plain path, fp32) count
  the reference's FLOPs within 1% (they agree exactly); the training step
  differs by the terms ``test_training_step_flops_against_reference``
  states.
- Each kernel wrapper's ``meta`` branch returns its plain version's
  shapes and dtypes and reports the work of its bound's formula; outside
  a counter it raises.
- The footprint counts live storages and their frees; ``breakdown``'s
  counted report and its profile split (rehearsed on the CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.hlo import analyze_hlo  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.configs import cells_for as jax_cells_for  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.analysis import breakdown, opcount  # noqa: E402
from repro_torch.analysis import roofline as roof  # noqa: E402
from repro_torch.common.platform import H100_SXM  # noqa: E402
from repro_torch.configs import (ARCH_IDS, cells_for, get_config,  # noqa: E402
                                 get_reduced)
from repro_torch.models.model import Model  # noqa: E402

META = "meta"


# ---------------------------------------------------------------------------
# roofline: parameter counts, model FLOPs, terms, kernel bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()
    cells, jcells = cells_for(cfg), jax_cells_for(jcfg)
    assert [c.name for c in cells] == [c.name for c in jcells]
    for cell, jcell in zip(cells, jcells):
        assert roof.model_flops_for(cfg, cell) == \
            jroof.model_flops_for(jcfg, jcell)


def test_derive_terms_on_h100_by_hand():
    flops, nbytes, model = 4.945e15, 6.7e12, 3.0e15
    t = roof.derive_terms(arch="a", cell="c", mesh_name="single", chips=1,
                          cost={"flops": flops, "bytes accessed": nbytes},
                          collective=roof.CollectiveStats(),
                          model_flops=model, peak_memory_bytes=2 * 2**30)
    assert t.compute_s == pytest.approx(5.0)          # 4.945e15 / 989e12
    assert t.memory_s == pytest.approx(2.0)           # 6.7e12 / 3.35e12
    assert t.collective_s == 0.0 and t.dominant == "compute"
    assert t.bound_s == pytest.approx(5.0)
    assert t.roofline_fraction == pytest.approx(model / 989e12 / 5.0)
    assert t.useful_flops_ratio == pytest.approx(model / flops)
    row = t.row()
    jrow = jroof.derive_terms(
        arch="a", cell="c", mesh_name="single", chips=1,
        cost={"flops": flops, "bytes accessed": nbytes},
        collective=jroof.CollectiveStats({}, {}), model_flops=model,
        platform=dataclasses.replace(H100_SXM, ici_bw=1.0, ici_links=1)
    ).row()
    assert set(row) == set(jrow)
    assert row["peak_memory_gib"] == pytest.approx(2.0)
    with pytest.raises(ValueError, match="no inter-chip link"):
        roof.derive_terms(arch="a", cell="c", mesh_name="single", chips=1,
                          cost={}, collective=roof.CollectiveStats(
                              {"all-reduce": 1.0}, {"all-reduce": 1}),
                          model_flops=0.0)


# (row, work, dtype, exponentials, the table's ms, its last digit, by)
@pytest.mark.parametrize("row,work,dtype,exps,want,unit,by", [
    # ragged decode: 8 slots, 24 on 8 heads, D 128, bf16, 3043 live rows
    ("ragged decode", roof.ragged_decode_work(8, 24, 8, 128, 2, 3043),
     "bfloat16", 0, 0.00375, 1e-5, "bytes"),
    # flash: a causal 1024-token prompt, 24 on 8 heads, D 128, bf16
    ("flash S 1024", roof.flash_work(
        1024 * 24 * 128, 2 * 1024 * 8 * 128, 128,
        roof.attended_pairs(1, 1024, 24, True), 2), "bfloat16", 0,
     0.00652, 1e-5, "operations"),
    # the scan backward at falcon's training layer: B 4, S 1024, d_in 8192
    ("scan backward", roof.scan_train_work(4, 1024, 8192, 16, 2)[1::3],
     "float32", roof.scan_train_work(4, 1024, 8192, 16, 2)[2], 0.1808,
     1e-4, "bytes"),
])
def test_kernel_bound_reproduces_perf_table_rows(row, work, dtype, exps,
                                                 want, unit, by):
    ms, bound_by = roof.kernel_bound(*work, dtype, exps=exps)
    assert abs(ms - want) <= unit / 2, row
    assert bound_by == by


# ---------------------------------------------------------------------------
# opcount against the reference's analyze_hlo
# ---------------------------------------------------------------------------

def _jax_flops(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text())


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device=META)


def _scan_free(x, w, np_):
    return np_.tanh(x @ w) @ w


def _loop(n):
    def f(x, w):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x
    return f


def _jax_scan(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    return jax.lax.scan(body, x, None, length=10)[0]


def _jax_nested(x, w):
    def outer(c, _):
        def inner(ci, _):
            return ci @ w, None
        return jax.lax.scan(inner, c, None, length=4)[0], None
    return jax.lax.scan(outer, x, None, length=5)[0]


def _nested(x, w):
    for _ in range(5):
        for _ in range(4):
            x = x @ w
    return x


@pytest.mark.parametrize("name,jax_fn,torch_fn", [
    ("scan-free", lambda x, w: _scan_free(x, w, jnp),
     lambda x, w: _scan_free(x, w, torch)),
    ("scan of 10 / Python loop", _jax_scan, _loop(10)),
    ("nested scans 5 x 4 / nested loops", _jax_nested, _nested),
])
def test_toy_program_flops_equal_analyze_hlo(name, jax_fn, torch_fn):
    want = _jax_flops(jax_fn, (128, 128), (128, 128)).flops
    _, cost = opcount.count(torch_fn, _meta(128, 128), _meta(128, 128))
    assert cost.flops == want, name
    assert cost.collective_bytes == 0 and not cost.collective_by_kind


def test_matmul_bytes_are_operands_plus_result():
    expect = 3 * 256 * 256 * 4
    ref = _jax_flops(lambda x, w: x @ w, (256, 256), (256, 256))
    assert expect <= ref.bytes <= 3 * expect    # the reference's range
    _, cost = opcount.count(lambda x, w: x @ w, _meta(256, 256),
                            _meta(256, 256))
    assert cost.bytes == expect
    assert cost.flops == ref.flops == 2 * 256 ** 3


B, T = 2, 64


@pytest.fixture(scope="module")
def minitron_pair():
    jcfg = dataclasses.replace(jax_get_reduced("minitron-4b"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_reduced("minitron-4b"), dtype="float32")
    jm = jax_build_model(jcfg)
    return jm, strip(jm.init(jax.random.key(0))), Model(tcfg, META)


def _compiled_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _ids(*shape):
    return torch.zeros(shape, dtype=torch.int32, device=META)


def test_decode_and_prefill_flops_equal_reference(minitron_pair):
    """Plain path, fp32: every product of the step is a torch product the
    flop counter knows, as every dot of the reference's HLO: held to 1%,
    they agree exactly."""
    jm, jp, tm = minitron_pair
    cache = strip(jm.init_cache(B, T))
    jd = _compiled_flops(lambda p, c, t: jm.decode_step(p, c, t), jp, cache,
                         jnp.zeros((B, 1), jnp.int32))
    jpf = _compiled_flops(lambda p, c, b: jm.prefill(p, b, c), jp, cache,
                          {"tokens": jnp.zeros((B, T), jnp.int32)})
    tp = tm.init(None)
    _, cd = opcount.count(lambda: tm.decode_step(
        tp, tm.init_cache(B, T), _ids(B, 1), use_kernels=False))
    _, cp = opcount.count(lambda: tm.prefill(
        tp, {"tokens": _ids(B, T)}, tm.init_cache(B, T), use_kernels=False))
    assert cd.flops == pytest.approx(jd, rel=1e-2)
    assert cp.flops == pytest.approx(jpf, rel=1e-2)
    assert (cd.flops, cp.flops) == (jd, jpf) == (360448, 18939904)


def test_training_step_flops_against_reference(minitron_pair):
    """The train step (AdamW, remat, plain path, fp32) of reduced minitron
    at B 2 x S 64: the port counts the reference's FLOPs less two terms
    and plus one, exactly.

    - Cross-entropy: the reference pads each row to its 512-token chunk
      and takes three products of the chunk with the LM head (forward and
      two backward); the port's chunks are not padded and are
      checkpointed: four products (forward, recompute, two backward) of
      the 128 tokens alone.
    - Attention: the port's plain flash backward recomputes the scores
      (five products a pair: scores, dP, dV, dQ, dK), where the
      reference's backward reuses those of its remat recompute (four).
    - Both skip each layer's last product in the recompute (torch's
      checkpoint early stop; XLA's dead-code elimination), so that term
      cancels.  The tolerance is 0 after the terms."""
    import functools
    from repro.optim import base as joptim
    from repro.train.trainer import TrainConfig as JTrainConfig
    from repro.train.trainer import make_train_step as jax_train_step
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainConfig, make_train_step

    jm, jp, tm = minitron_pair
    jopt = joptim.make_optimizer("adamw")
    jt = _compiled_flops(jax_train_step(jm, jopt, JTrainConfig()), jp,
                         jopt.init(jp), jnp.int32(1),
                         {"tokens": jnp.zeros((B, T), jnp.int32),
                          "labels": jnp.zeros((B, T), jnp.int32)})
    tp = tm.init(None, dtype="float32")
    opt = make_optimizer("adamw")
    state = opt.init(tp)
    model = Model(tm.cfg, META)
    model.loss = functools.partial(Model.loss, model, use_kernels=False)
    step = make_train_step(model, opt, TrainConfig())
    batch = {"tokens": _ids(B, T), "labels": _ids(B, T)}
    _, cost = opcount.count(lambda: step(tp, state, 1, batch), live=(
        tp, state, batch))
    cfg = tm.cfg
    d, V = cfg.d_model, cfg.padded_vocab
    ref_xent = 3 * 2 * B * 512 * d * V
    port_xent = 4 * 2 * B * T * d * V
    H, D = cfg.num_heads, cfg.resolved_head_dim
    scores = cfg.num_layers * 2 * B * H * T * T * D
    assert cost.flops == jt - ref_xent + port_xent + scores
    # 16 bytes a parameter live: params, grads, m and v
    assert cost.peak_bytes >= 16 * cfg.param_count()


# ---------------------------------------------------------------------------
# the kernel wrappers' meta branches
# ---------------------------------------------------------------------------

def _rand(*shape, dtype=torch.float32, gen=None):
    return torch.randn(shape, generator=gen).to(dtype)


def _flash_inputs():
    g = torch.Generator().manual_seed(0)
    q = _rand(2, 40, 4, 16, dtype=torch.bfloat16, gen=g)
    k = _rand(2, 40, 2, 16, dtype=torch.bfloat16, gen=g)
    v = _rand(2, 40, 2, 16, dtype=torch.bfloat16, gen=g)
    return q, k, v


def _case_flash(fa):
    q, k, v = _flash_inputs()
    pairs = roof.attended_pairs(2, 40, 4, True)
    work = roof.flash_work(q.numel(), 2 * k.numel(), 16, pairs, 2)
    return (lambda *t: fa.flash_attention(*t), (q, k, v),
            "flash_attention", work)


def _case_flash_lse(fa):
    q, k, v = _flash_inputs()
    pairs = roof.window_pairs(2, 40, 4, 8)
    work = roof.flash_work(q.numel(), 2 * k.numel(), 16, pairs, 2,
                           2 * 40 * 4)
    return (lambda *t: fa.flash_attention_lse(*t, window=8), (q, k, v),
            "flash_attention_lse_window", work)


def _case_flash_bwd(fa):
    q, k, v = _flash_inputs()
    out, lse = fa.flash_attention_lse(q, k, v, causal=False)
    dout = torch.randn_like(out)
    pairs = roof.attended_pairs(2, 40, 4, False)
    work = roof.flash_bwd_work(q.numel(), 2 * k.numel(), 16, pairs, 2,
                               lse.numel())
    return (lambda *t: fa.flash_attention_bwd(*t, causal=False),
            (q, k, v, out, dout, lse), "flash_attention_bwd_bidir", work)


def _case_ragged():
    from repro_torch.kernels.ragged_decode import ops as rd
    g = torch.Generator().manual_seed(1)
    q = _rand(3, 1, 4, 16, gen=g)
    k, v = _rand(3, 24, 2, 16, gen=g), _rand(3, 24, 2, 16, gen=g)
    lens = torch.tensor([24, 5, 11], dtype=torch.int32)
    return (lambda q, k, v, n: rd.ragged_decode_attention(q, k, v, n),
            (q, k, v, lens), "ragged_decode",
            roof.ragged_decode_work(3, 4, 2, 16, 4, 3 * 24))


def _mamba_args(B=2, d=16, d_in=32, R=4, N=4, w=4, S=None):
    g = torch.Generator().manual_seed(2)
    f32 = dict(gen=g)
    return dict(
        x1=_rand(B, 1, d, **f32), conv=_rand(B, w - 1, d_in, **f32),
        h=_rand(B, d_in, N, **f32), in_proj=_rand(d, 2 * d_in, **f32),
        conv_w=_rand(w, d_in, **f32), conv_b=_rand(d_in, **f32),
        x_proj=_rand(d_in, R + 2 * N, **f32), dt_proj=_rand(R, d_in, **f32),
        dt_bias=_rand(d_in, **f32), a_log=_rand(d_in, N, **f32),
        d=_rand(d_in, **f32), out_proj=_rand(d_in, d, **f32))


def _case_mamba_step():
    from repro_torch.kernels.mamba_scan import ops as ms
    a = _mamba_args()
    nbytes, flops, _ = roof.mamba_step_work(2, 16, 32, 4, 4, 4, 4, 2)
    return (lambda *t: ms.mamba_step(*t), tuple(a.values()), "mamba_step",
            (nbytes, flops))


def _scan_inputs():
    g = torch.Generator().manual_seed(3)
    x = _rand(2, 40, 8, gen=g)
    dt = torch.nn.functional.softplus(_rand(2, 40, 8, gen=g))
    b, c = _rand(2, 40, 4, gen=g), _rand(2, 40, 4, gen=g)
    return x, dt, b, c, -_rand(8, 4, gen=g).abs(), _rand(8, gen=g)


def _case_scan():
    from repro_torch.kernels.mamba_scan import ops as ms
    nbytes, _, flops = roof.scan_work(2, 40, 8, 4, 4)
    return (lambda *t: ms.mamba_scan(*t), _scan_inputs(), "mamba_scan",
            (nbytes, flops))


def _case_scan_train():
    from repro_torch.kernels.mamba_scan import ops as ms
    fb, _, _, ff, _ = roof.scan_train_work(2, 40, 8, 4, 4)
    return (lambda *t: ms.mamba_scan(*t, bounds=True), _scan_inputs(),
            "mamba_scan_train", (fb, ff))


def _case_scan_bwd():
    from repro_torch.kernels.mamba_scan import ops as ms
    ins = _scan_inputs()
    bnd = ms.mamba_scan(*ins, bounds=True)[2]
    gy = torch.randn(2, 40, 8)
    _, bb, _, _, bf = roof.scan_train_work(2, 40, 8, 4, 4)
    return (lambda *t: ms.mamba_scan_bwd(*t), ins + (bnd, gy),
            "mamba_scan_bwd", (bb, bf))


def _case_mm(name):
    from repro_torch.kernels.filco_mm import ops as fm
    g = torch.Generator().manual_seed(4)
    a, b = _rand(24, 40, gen=g), _rand(40, 16, gen=g)
    if name == "flex_mm":
        fn = lambda a, b, dims: fm.flex_mm(a, b, dims)  # noqa: E731
        args = (a, b, torch.tensor([24, 40, 16], dtype=torch.int32))
    else:
        fn, args = (lambda a, b: fm.static_mm(a, b)), (a, b)
    return fn, args, name, roof.mm_work(24, 40, 16, 4)


def _cases():
    from repro_torch.kernels.flash_attention import ops as fa
    return {"flash_attention": lambda: _case_flash(fa),
            "flash_attention_lse": lambda: _case_flash_lse(fa),
            "flash_attention_bwd": lambda: _case_flash_bwd(fa),
            "ragged_decode": _case_ragged, "mamba_step": _case_mamba_step,
            "mamba_scan": _case_scan, "mamba_scan_train": _case_scan_train,
            "mamba_scan_bwd": _case_scan_bwd,
            "flex_mm": lambda: _case_mm("flex_mm"),
            "static_mm": lambda: _case_mm("static_mm")}


def _flat(out):
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_meta_branch_shapes_and_work(case):
    fn, args, kernel, (nbytes, flops) = _cases()[case]()
    want = _flat(fn(*args))
    meta_args = tuple(a.to(META) for a in args)
    got, cost = opcount.count(fn, *meta_args)
    got = _flat(got)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    assert all(t.device.type == META for t in got)
    assert cost.kernels == {kernel: [1, flops, nbytes]}
    assert cost.flops >= flops and cost.bytes >= nbytes
    with pytest.raises(RuntimeError, match="outside an OpCounter"):
        fn(*meta_args)


# ---------------------------------------------------------------------------
# footprint, report, profile split
# ---------------------------------------------------------------------------

def test_peak_counts_live_storages_and_frees():
    n = 1 << 20                                 # 4 MiB of fp32
    a = _meta(n)

    def step(a):
        b = a * 2
        c = b + 1                               # a, b, c live: the peak
        del b
        d = c * 3                               # a, c, d
        e = d[: n // 2]                         # a view: no new storage
        return e + 0                            # a, c?, d, the result

    _, cost = opcount.count(step, a, live=(a,))
    assert cost.peak_bytes == 3 * 4 * n + 2 * n
    # three elementwise ops read and write 4n bytes each, the last 2n
    assert cost.bytes == 3 * 2 * 4 * n + 2 * 2 * n


def test_report_names_the_top_modules_and_ops():
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import build_cell
    step, live = build_cell(get_reduced("minitron-4b"),
                            ShapeCell("t", 64, 2, "train"))
    _, cost = opcount.count(step, live=live)
    text = breakdown.report(cost, top=5)
    assert "module by TFLOP" in text and "op by TB" in text
    assert "models.layers.rms_norm" in cost.by_module
    assert "kernel:flash_attention_lse" in cost.by_op
    assert "flash_attention_bwd" in text and "totals/device" in text
    assert sum(r[1] for r in cost.by_module.values()) == \
        pytest.approx(cost.flops)


def test_kernel_and_stack_classes():
    assert breakdown.kernel_class(
        "void flash_bwd_dkdv_mma<128>(Params)") == "flash backward"
    assert breakdown.kernel_class("sm90_xmma_gemm_bf16bf16") == \
        "matmul (cuBLAS)"
    assert breakdown.kernel_class("elementwise_kernel") is None
    stack = ["torch/utils/checkpoint.py(354): checkpoint",
             "repro_torch/models/layers.py(26): rms_norm",
             "repro_torch/optim/base.py(151): update"]
    assert breakdown.stack_class(stack[1:]) == "norm"
    assert breakdown.stack_class(stack[2:]) == "optimizer (AdamW, Adafactor)"
    assert breakdown.stack_class(stack[:1]) is None
    assert breakdown.op_name_class("aten::_to_copy") == "casts and copies"
    assert breakdown.op_name_class("aten::mul") == breakdown.ELEMENTWISE


def _event(name, device=False, start=0.0, end=0.0, parent=None, seq=-1,
           kernels=(), id=None):
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Kernel
    return SimpleNamespace(
        id=id if id is not None else len(name) * 1000 + int(start * 10) + seq,
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
        cpu_children=[], stack=[], sequence_nr=seq,
        kernels=[Kernel(k, 0, us) for k, us in kernels])


def test_profile_split_of_card_events():
    """The device path on a hand-made profile: kernels classed by name,
    "other" by the operation that lists the kernel (a backward one by its
    forward operation's sequence number; a profiler marker inside the op
    that carries its id and lists its kernels again counts nothing), what
    no operation lists as unlinked; the classes sum to the device
    total."""
    norm = _event("repro_torch/models/layers.py(26): rms_norm")
    fwd = _event("aten::pow", parent=norm, seq=7,
                 kernels=[("elementwise_kernel", 10.0)])
    bwd = _event(breakdown._BACKWARD + "PowBackward0", seq=7)
    events = [norm, fwd, bwd,
              _event("aten::mul", parent=bwd, kernels=[("vec_mul", 4.0)]),
              _event("aten::mm", kernels=[("nvjet_tst_128x8", 20.0)]),
              _event("aten::_to_copy", start=1.0, end=9.0, id=77,
                     kernels=[("copy_kernel", 6.0)]),
              _event("Command Buffer Full", start=2.0, end=3.0, id=77,
                     kernels=[("copy_kernel", 6.0)]),
              _event("elementwise_kernel", True, 0.0, 10.0),
              _event("vec_mul", True, 10.0, 14.0),
              _event("nvjet_tst_128x8", True, 12.0, 32.0),
              _event("copy_kernel", True, 40.0, 46.0),
              _event("void flash_bwd_dq_mma<128>", True, 50.0, 55.0),
              _event("mamba_glue_without_op", True, 60.0, 61.0)]
    split = breakdown.split_profile(events, wall_s=100e-6)
    c = split["classes"]
    assert split["device_ms"] == pytest.approx(0.046)
    assert sum(c.values()) == pytest.approx(split["device_ms"])
    assert (c["flash backward"], c["matmul (cuBLAS)"], c["other"]) == \
        pytest.approx((0.005, 0.020, 0.021))
    assert split["other"] == pytest.approx(
        {"norm": 0.014, "casts and copies": 0.006,
         breakdown.UNLINKED: 0.001})
    assert split["busy_ms"] == pytest.approx(0.044)     # 0-32, 40-46, ...
    assert split["busy_share"] == pytest.approx(0.44)
    assert "other by class (ms): norm 0.0" in breakdown.format_split(split)


def test_profile_split_rehearsed_on_cpu():
    """The classifier of "other" on a real profile of a CPU step (stacks,
    parents and autograd sequence numbers as the profiler records them):
    each aten operation without children, forward or backward, takes its
    port function's class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainConfig, make_train_step
    cfg = get_reduced("minitron-4b")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), dtype="float32")
    opt = make_optimizer("adamw")
    state = opt.init(params)
    step = make_train_step(model, opt, TrainConfig())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    config = torch._C._profiler._ExperimentalConfig(verbose=True)
    with profile(activities=[ProfilerActivity.CPU], with_stack=True,
                 experimental_config=config) as prof:
        step(params, state, 1, batch)
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    classify = breakdown._Classifier(cpu)
    by_class = {}
    for e in cpu:
        if not e.cpu_children and e.name.startswith("aten::"):
            cls = classify(e)
            by_class[cls] = by_class.get(cls, 0) + e.self_cpu_time_total
    for cls in ("norm", "RoPE", "cross-entropy",
                "optimizer (AdamW, Adafactor)", "gradient clip"):
        assert by_class.get(cls, 0) > 0, (cls, by_class)
    assert breakdown.UNLINKED not in by_class
