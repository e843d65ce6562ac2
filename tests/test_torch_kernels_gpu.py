"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: each test skips without a CUDA device (decided in
the fixture, not at import).  Imports no JAX, so it runs on a machine with
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 to 2e-2 (a few bf16 ulps of O(1) outputs; kernel and
plain version round p at different points), fp32 to 1e-4 (summation order).
The Mamba step rounds at the reference's points in both versions, but sums
its products in another order, so a value may land on the neighbouring
bf16 (2**-8 of itself): it is held to tol + tol |want|.  The scan computes
in fp32 in both versions (the kernel's exponentials one MUFU.EX2 each,
within a few ulps): 1e-4 + 1e-4 |want|.  filco_mm sums in fp32 in
both versions and rounds once to the output dtype: tol + tol |want|; its
fp32 products are three TF32 products on the tensor cores, within about
1e-6 of fp32's.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.filco_mm import ops as fm  # noqa: E402
from repro_torch.kernels.filco_mm.ref import (flex_mm_ref,  # noqa: E402
                                              static_mm_ref)
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as ms  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_ref,  # noqa: E402
                                                mamba_step_ref, softplus)
from repro_torch.kernels.ragged_decode import ops as rd  # noqa: E402
from repro_torch.kernels.ragged_decode.ref import \
    ragged_decode_attention_ref  # noqa: E402
from repro_torch.workloads.decode import _WARMUP  # noqa: E402

GPU_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MAMBA_ORDER = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
               "dt_bias", "A_log", "D", "out_proj")


def _agree(got, want, tol):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all()
                and g.isfinite().all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _decode_shape(case, chunk_of):
    """(Hq, Hkv, T, lengths, live) of a ragged decode case; ``chunk_of(B,
    Hq, Hkv, T)`` is the kernel's chunk for that view."""
    if case == "mixed":                 # tile-edge lengths, one dead slot
        return 24, 8, 320, [1, 63, 64, 65, 300, 200], [1, 1, 1, 1, 1, 0]
    if case == "chunk_edges":           # T no multiple of the chunk
        c = chunk_of(6, 24, 8, 300)
        lens = [c - 1, c, c + 1, 1, 300, min(2 * c + 5, 300)]
        return 24, 8, 300, lens, [1, 1, 1, 1, 1, 0]
    if case == "all_dead":
        return 24, 8, 96, [5, 96, 40], [0, 0, 0]
    if case == "long":                  # B = 1: many splits
        return 24, 8, 2048, [2000], [1]
    if case == "g1":
        return 8, 8, 160, [1, 150, 33], [1, 1, 1]
    if case == "g8":
        return 64, 8, 160, [160, 77, 1], [1, 0, 1]
    if case == "g9":                    # two head groups, of 5 and 4
        return 18, 2, 320, [1, 63, 64, 65, 300, 200], [1, 1, 1, 1, 1, 0]
    if case == "g48":                   # granite's multi-query group, 6 x 8
        return 48, 1, 1056, [1000, 517, 129, 1, 64, 999, 700, 333], \
            [1, 1, 1, 1, 1, 1, 0, 1]
    raise ValueError(case)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window,cap,glob", [(0, 0.0, None), (40, 20.0, False),
                                             (40, 20.0, True)])
@pytest.mark.parametrize("case", ["mixed", "chunk_edges", "all_dead", "long",
                                  "g1", "g8", "g9", "g48"])
def test_ragged_decode_kernel_on_gpu(cuda, dtype, window, cap, glob, case):
    """Lengths at the chunk's edges, length 1, dead slots (all of them in
    one case), G in {1, 3, 8, 9, 48} (past 8 in head groups of at most 8);
    with the window of 40 the window's start falls inside a later chunk of
    the long rows.  K and V are strided views of a longer cache, as the
    engine passes them."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    Hq, Hkv, T, lengths, alive = _decode_shape(
        case, lambda B, Hq, Hkv, T: rd.split_plan(B, Hq, Hkv, T, sms)[0])
    B, D = len(lengths), 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, 1, Hq, D), generator=gen, device=cuda).to(dtype)
    kc = torch.randn((B, T + 64, Hkv, D), generator=gen, device=cuda).to(dtype)
    vc = torch.randn((B, T + 64, Hkv, D), generator=gen, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    live = torch.tensor(alive, dtype=torch.bool, device=cuda)
    k, v = kc[:, :T], vc[:, :T]          # strided view, as the engine
    kw = dict(window=window, logit_cap=cap, is_global=glob, live=live)
    before = rd.launches
    got = rd.ragged_decode_attention(q, k, v, lens, **kw)
    want = ragged_decode_attention_ref(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert rd.launches == before + 1
    for b, a in enumerate(alive):
        assert a or (got[b] == 0).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 32, 63, 64, 65, 127, 128, 129, 200, 1000,
                               1024])
@pytest.mark.parametrize("window,cap,glob", [(0, 0.0, None), (64, 30.0, False),
                                             (64, 30.0, True)])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("fused", [False, True])
def test_flash_kernel_on_gpu(cuda, dtype, S, window, cap, glob, G, D, fused):
    """``fused``: q, k and v are strided views of one (1, S, Hq + 2 Hkv, D)
    projection."""
    Hkv = 8
    Hq = G * Hkv
    gen = torch.Generator(device=cuda).manual_seed(1)
    if fused:
        qkv = torch.randn((1, S, Hq + 2 * Hkv, D), generator=gen,
                          device=cuda).to(dtype)
        q, k, v = (qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv],
                   qkv[:, :, Hq + Hkv:])
    else:
        q, k, v = (torch.randn((1, S, h, D), generator=gen,
                               device=cuda).to(dtype) for h in (Hq, Hkv, Hkv))
    kw = dict(window=window, logit_cap=cap, is_global=glob)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 63, 65, 200, 1024])
@pytest.mark.parametrize("case", ["causal", "window", "kv_len",
                                  "bidirectional"])
@pytest.mark.parametrize("D", [24, 192, 256])
def test_flash_kernel_mla_head_dims_on_gpu(cuda, dtype, S, case, D):
    """Head dims of MLA's prefill: 24 (deepseek-v2-lite-reduced's qk dim,
    rows of 48 bytes in bf16), 192 (deepseek-v2-lite's) and 256, over 16
    heads (MLA's G = 1), v zero past 128 as MLA pads it; causal, windowed
    with a cap, key-padded (B = 3) and bidirectional.  Each launch counts
    on its head dim's counter."""
    B = 3 if case == "kv_len" else 1
    gen = torch.Generator(device=cuda).manual_seed(D + S)
    q, k, v = (torch.randn((B, S, 16, D), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    if D > 128:
        v[..., 128:] = 0
    kw = {"causal": dict(), "window": dict(window=64, logit_cap=30.0),
          "kv_len": dict(kv_len=torch.tensor(
              [S, max(S // 2, 1), min(5, S)], dtype=torch.int32,
              device=cuda)),
          "bidirectional": dict(causal=False)}[case]
    counter = ("masked_launches" if case == "kv_len" else
               {24: "launches", 192: "d192_launches",
                256: "d256_launches"}[D])
    before = getattr(fa, counter)
    got = fa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert getattr(fa, counter) == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dtype] and got.isfinite().all(), err
    if D > 128:
        assert bool((got[..., 128:] == 0).all())


# flash backward shapes: (label, B, S, Hq, Hkv, D) - minitron-4b's heads at
# its training batch, granite's multi-query heads, llama-100m's D 64, a
# length that is no multiple of the tile, the small head dims (24 pads
# to the tensor-core kernel's 32, 16 is its least), and above 128 the
# eight-warp instances: deepseek-v2-lite's MLA at its training batch (q/k
# head dim 192, 16 heads on 16), a group of 8 on one KV head at 192 (the
# plan splits it) and 136 (zero-padded to 192)
BWD_SHAPES = (("minitron", 4, 1024, 24, 8, 128), ("granite", 1, 1024, 48, 1, 128),
              ("llama-100m", 8, 256, 10, 5, 64), ("S1000", 1, 1000, 24, 8, 128),
              ("D24", 2, 130, 6, 2, 24), ("D16", 1, 200, 4, 1, 16),
              ("MLA", 4, 1024, 16, 16, 192), ("D192 G8", 1, 200, 8, 1, 192),
              ("D136", 1, 130, 4, 2, 136))


def _bwd_counters(D):
    """The wrapper's (lse, backward) launch counters at head dim D."""
    if D > 128:
        return fa.lse_d192_launches, fa.bwd_d192_launches
    return fa.lse_launches, fa.bwd_launches


def _bwd_inputs(cuda, B, S, Hq, Hkv, D, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, dout = (torch.randn((B, S, Hq, D), generator=gen, device=cuda).to(dtype)
               for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    return q, k, v, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=[s[0] for s in BWD_SHAPES])
def test_flash_backward_kernel_on_gpu(cuda, dtype, causal, shape):
    """The forward's lse and the backward kernel's (dq, dk, dv) against
    their plain versions on the same (q, k, v, out, dout, lse); each
    launch counts once."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    _, B, S, Hq, Hkv, D = shape
    q, k, v, dout = _bwd_inputs(cuda, B, S, Hq, Hkv, D, dtype, S + D)
    before = _bwd_counters(D)
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    out_r, lse_r = flash_attention_lse_ref(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal)
    torch.cuda.synchronize()
    assert _bwd_counters(D) == (before[0] + 1, before[1] + 1)
    tol = GPU_TOL[dtype]
    assert _agree(out, out_r, tol)
    assert (lse - lse_r).abs().max().item() <= tol
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _agree(a, b, tol), (name, (a.float() - b.float()).abs().max())


@pytest.mark.gpu
def test_flash_autograd_on_gpu_matches_plain(cuda):
    """``flash_attention`` under autograd on the card (the kernel Function)
    against the plain Function's gradients, bf16 at minitron's heads."""
    from repro_torch.models.layers import blockwise_attention
    q, k, v, dout = _bwd_inputs(cuda, 2, 300, 24, 8, 128, torch.bfloat16, 7)
    grads = []
    for fn in (fa.flash_attention, blockwise_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, causal=True).backward(dout)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _agree(a, b, GPU_TOL[torch.bfloat16])


@pytest.mark.gpu
def test_flash_autograd_at_mla_head_dim_matches_plain(cuda):
    """MLA's attention under autograd on the card: q and k at head dim
    192, v zero-padded from 128, the output sliced back to 128 (as
    ``attention._mla_attend`` does), through the kernel Function and the
    plain one; bf16 gradients agree, and the pad's columns of dv are
    zero in both."""
    from repro_torch.models.layers import blockwise_attention
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k = (torch.randn((2, 300, 16, 192), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    v, dout = (torch.randn((2, 300, 16, 128), generator=gen,
                           device=cuda).to(torch.bfloat16) for _ in range(2))
    grads = []
    before = fa.bwd_d192_launches
    for fn in (fa.flash_attention, blockwise_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        vpad = torch.nn.functional.pad(leaves[2], (0, 64))
        fn(leaves[0], leaves[1], vpad, causal=True)[..., :128].backward(dout)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert fa.bwd_d192_launches == before + 1
    for a, b in zip(*grads):
        assert _agree(a, b, GPU_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 1024, 16, 16), (1, 200, 8, 1)],
                         ids=["MLA", "G8 split"])
def test_flash_backward_d192_is_deterministic(cuda, dtype, shape):
    """At head dim 192, repeated calls are bitwise equal: MLA's training
    shape, and a group of 8 on one KV head whose plan splits it over
    dK/dV blocks and folds the partials."""
    B, S, Hq, Hkv = shape
    q, k, v, dout = _bwd_inputs(cuda, B, S, Hq, Hkv, 192, dtype, 13)
    out, lse = fa.flash_attention_lse(q, k, v)
    runs = [fa.flash_attention_bwd(q, k, v, out, dout, lse) for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], other))


@pytest.mark.gpu
def test_flash_backward_d192_takes_the_tensor_cores(cuda):
    """At MLA's training shape a call is two launches (G = 1: no split):
    the eight-warp tensor-core instances in bf16, the CUDA-core ones of
    twelve columns a thread in fp32."""
    from repro_torch.kernels import _build
    B, S, Hq, Hkv, D = 4, 1024, 16, 16, 192
    assert fa.bwd_plan(B, S, Hq, Hkv, _build.sm_count(cuda.index or 0),
                       D) == 1
    for dtype, kind in ((torch.bfloat16, "mma8<192>"),
                        (torch.float32, "simt<12>")):
        q, k, v, dout = _bwd_inputs(cuda, B, S, Hq, Hkv, D, dtype, 14)
        out, lse = fa.flash_attention_lse(q, k, v)
        names = _kernels_of(lambda: fa.flash_attention_bwd(q, k, v, out,
                                                           dout, lse))
        assert len(names) == 2, names
        for kernel in (f"flash_bwd_dq_{kind}", f"flash_bwd_dkdv_{kind}"):
            assert any(kernel in n for n in names), names


@pytest.mark.gpu
def test_flash_backward_is_deterministic(cuda):
    q, k, v, dout = _bwd_inputs(cuda, 2, 200, 48, 1, 128, torch.bfloat16, 3)
    out, lse = fa.flash_attention_lse(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    b = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _kernels_of(fn):
    """The names of the device kernels one call of ``fn`` launches, as
    the profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_split_is_deterministic(cuda, dtype):
    """Granite's 48 query heads on 1 KV head at B 1, S 1024: the plan
    splits the group over dK/dV blocks, a third launch folds the fp32
    partials; repeated calls are bitwise equal, and agree with the plain
    split and the plain unsplit backward."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_bwd_split_ref)
    q, k, v, dout = _bwd_inputs(cuda, 1, 1024, 48, 1, 128, dtype, 11)
    n_split = fa.bwd_plan(1, 1024, 48, 1, _build.sm_count(cuda.index or 0))
    assert n_split > 1 and 48 % n_split == 0
    out, lse = fa.flash_attention_lse(q, k, v)
    got = []
    names = _kernels_of(lambda: got.append(
        fa.flash_attention_bwd(q, k, v, out, dout, lse)))
    assert len(names) == 3, names
    assert any("flash_bwd_fold" in n for n in names), names
    b = fa.flash_attention_bwd(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got[0], b))
    split = flash_attention_bwd_split_ref(q, k, v, out, dout, lse,
                                          n_split=n_split)
    plain = flash_attention_bwd_ref(q, k, v, out, dout, lse)
    for x, w1, w2 in zip(b, split, plain):
        assert _agree(x, w1, GPU_TOL[dtype])
        assert _agree(x, w2, GPU_TOL[dtype])


@pytest.mark.gpu
def test_flash_backward_bf16_takes_the_tensor_cores(cuda):
    """At minitron's training shape a call is two launches, no split: the
    tensor-core instances in bf16, the CUDA-core ones in fp32; repeated
    calls are bitwise equal."""
    from repro_torch.kernels import _build
    B, S, Hq, Hkv, D = 4, 1024, 24, 8, 128
    assert fa.bwd_plan(B, S, Hq, Hkv, _build.sm_count(cuda.index or 0)) == 1
    for dtype, kind in ((torch.bfloat16, "mma<128>"), (torch.float32, "simt<8>")):
        q, k, v, dout = _bwd_inputs(cuda, B, S, Hq, Hkv, D, dtype, 12)
        out, lse = fa.flash_attention_lse(q, k, v)
        names = _kernels_of(lambda: fa.flash_attention_bwd(q, k, v, out,
                                                           dout, lse))
        assert len(names) == 2, names
        for kernel in (f"flash_bwd_dq_{kind}", f"flash_bwd_dkdv_{kind}"):
            assert any(kernel in n for n in names), names
        a = fa.flash_attention_bwd(q, k, v, out, dout, lse)
        b = fa.flash_attention_bwd(q, k, v, out, dout, lse)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_flash_backward_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 4, 128), device=cuda, requires_grad=True)
    k = torch.zeros((1, 64, 2, 128), device=cuda, requires_grad=True)
    for kw in (dict(logit_cap=5.0),
               dict(kv_len=torch.ones(1, dtype=torch.int32, device=cuda))):
        with pytest.raises(NotImplementedError):
            fa.flash_attention(q, k, k, **kw)
    q2 = torch.zeros((1, 64, 4, 256), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention(q2, q2[:, :, :2], q2[:, :, :2])


# windowed backward cases: (label, Hq, Hkv, D) - hymba's heads (the
# four-warp instance at head dim 64), head dim 128, the eight-warp
# instance at 192, and multi-query at 16
WINDOW_BWD_SHAPES = (("hymba", 25, 5, 64), ("D128", 8, 2, 128),
                     ("D192", 4, 4, 192), ("D16 MQA", 4, 1, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [65, 300, 1100, 2048])
@pytest.mark.parametrize("window", [64, 100, 1024])
@pytest.mark.parametrize("glob", [False, True])
@pytest.mark.parametrize("shape", WINDOW_BWD_SHAPES,
                         ids=[s[0] for s in WINDOW_BWD_SHAPES])
def test_flash_backward_window_on_gpu(cuda, dtype, S, window, glob, shape):
    """The forward's lse and the backward kernel under a sliding window
    (causal; a global layer bypasses it) against their plain versions;
    a windowed call counts on the window counters, a global one on the
    head dim's."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    _, Hq, Hkv, D = shape
    q, k, v, dout = _bwd_inputs(cuda, 1, S, Hq, Hkv, D, dtype, S + window)
    kw = dict(causal=True, window=window, is_global=glob)
    before = (fa.lse_window_launches, fa.bwd_window_launches,
              *_bwd_counters(D))
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    out_r, lse_r = flash_attention_lse_ref(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    after = (fa.lse_window_launches, fa.bwd_window_launches,
             *_bwd_counters(D))
    bump = (0, 0, 1, 1) if glob else (1, 1, 0, 0)
    assert tuple(a - b for a, b in zip(after, before)) == bump
    tol = GPU_TOL[dtype]
    assert _agree(out, out_r, tol)
    assert (lse - lse_r).abs().max().item() <= tol
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _agree(a, b, tol), (name, (a.float() - b.float()).abs().max())


@pytest.mark.gpu
def test_flash_autograd_window_on_gpu_matches_plain(cuda):
    """hymba's sliding-window attention under autograd on the card (the
    kernel Function) against the plain Function, bf16, S 2048 past its
    window of 1024."""
    from repro_torch.models.layers import blockwise_attention
    q, k, v, dout = _bwd_inputs(cuda, 1, 2048, 25, 5, 64, torch.bfloat16, 6)
    grads = []
    before = fa.bwd_window_launches
    for fn in (fa.flash_attention, blockwise_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, causal=True, window=1024, is_global=False).backward(dout)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert fa.bwd_window_launches == before + 1
    for a, b in zip(*grads):
        assert _agree(a, b, GPU_TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [0, 1024])
def test_flash_backward_window_is_deterministic(cuda, dtype, window):
    """Repeated windowed and unwindowed backward calls at hymba's training
    shape (B 2, S 2048) are bitwise equal."""
    q, k, v, dout = _bwd_inputs(cuda, 2, 2048, 25, 5, 64, dtype, 15)
    out, lse = fa.flash_attention_lse(q, k, v, window=window)
    runs = [fa.flash_attention_bwd(q, k, v, out, dout, lse, window=window)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], other))


def _kv_case(cuda, B, S, D, dtype, lens):
    """(q, k, v, kv_len) of a key-padded flash case: H = 16 heads (G = 1,
    seamless-m4t's attention), ``lens`` the valid keys per row."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((B, S, 16, D), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda)


def _drawn_lens(B, S):
    """Per-row lengths drawn in [1, S]; the last row is S itself."""
    gen = torch.Generator().manual_seed(B * 10007 + S)
    lens = torch.randint(1, S + 1, (B,), generator=gen).tolist()
    lens[-1] = S
    return lens


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1024])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_kv_len_on_gpu(cuda, dtype, B, S, D, causal):
    """Per-row key padding: key ``j`` of row ``b`` counts only where
    ``j < kv_len[b]``; query rows past a row's length are held too."""
    q, k, v, lens = _kv_case(cuda, B, S, D, dtype, _drawn_lens(B, S))
    before = (fa.launches, fa.masked_launches)
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=lens)
    want = flash_attention_ref(q, k, v, causal=causal, kv_len=lens)
    torch.cuda.synchronize()
    assert (fa.launches, fa.masked_launches) == (before[0], before[1] + 1)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dtype] and got.isfinite().all(), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 63, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_kv_len_zero_rows_on_gpu(cuda, dtype, S, causal):
    """Rows of length 0 (a batch row that holds no job, as the engines
    pass them) give what the plain version gives, never NaN."""
    q, k, v, lens = _kv_case(cuda, 4, S, 64, dtype, [0, min(5, S), 0, S])
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=lens)
    want = flash_attention_ref(q, k, v, causal=causal, kv_len=lens)
    torch.cuda.synchronize()
    assert got.isfinite().all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["granite", "hymba"])
@pytest.mark.parametrize("glob", [False, True])
@pytest.mark.parametrize("S", [1, 65, 1100])
def test_flash_kernel_at_the_new_families_heads(cuda, dtype, shape, glob, S):
    """granite: multi-query, 48 query heads on 1 KV head, head dim 128,
    causal; hymba: 25 heads on 5, head dim 64, a sliding window of 1024
    (S 1100 crosses it) or a global layer."""
    Hq, Hkv, D, window = {"granite": (48, 1, 128, 0),
                          "hymba": (25, 5, 64, 1024)}[shape]
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn((1, S, h, D), generator=gen,
                           device=cuda).to(dtype) for h in (Hq, Hkv, Hkv))
    kw = dict(causal=True, window=window, is_global=glob)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_kv_len_is_deterministic(cuda, dtype):
    """Two launches on the same inputs are bitwise equal."""
    q, k, v, lens = _kv_case(cuda, 8, 1024, 64, dtype, _drawn_lens(8, 1024))
    a = fa.flash_attention(q, k, v, causal=False, kv_len=lens)
    b = fa.flash_attention(q, k, v, causal=False, kv_len=lens)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((2, 1, 4, 64), dtype=torch.float16, device=cuda)
    k = torch.zeros((2, 8, 2, 64), dtype=torch.float16, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rd.ragged_decode_attention(q, k, k, lens)
    q5 = torch.zeros((1, 1, 5, 64), dtype=torch.bfloat16, device=cuda)
    k5 = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                 # Hq not a multiple of Hkv
        rd.ragged_decode_attention(q5, k5, k5, lens[:1])
    for D in (264, 4):           # above 256; rows of 8 bytes
        qb = torch.zeros((1, 8, 4, D), dtype=torch.bfloat16, device=cuda)
        kb = torch.zeros((1, 8, 2, D), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError):
            fa.flash_attention(qb, kb, kb)
    qw = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                 # kv_len with a window
        fa.flash_attention(qw, qw, qw, window=4, kv_len=lens)
    with pytest.raises(ValueError):                 # kv_len not int32
        fa.flash_attention(qw, qw, qw, kv_len=lens.long())


@pytest.mark.gpu
def test_engine_on_gpu_kernel_path_matches_plain_path(cuda):
    """The decode engine on the card, reduced minitron in fp32: streams
    with both kernels on equal the plain path's, and every layer of every
    prefill and decode step launched its kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import DecodeEngine, ServeConfig

    cfg = dataclasses.replace(get_reduced("minitron-4b"), dtype="float32")
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
               for n in rng.integers(3, 40, size=5)]
    streams = {}
    for kern in (True, False):
        eng = DecodeEngine(model, params, ServeConfig(
            max_slots=3, max_len=64, eos_id=-1, use_kernels=kern,
            kv_page_rows=4, kv_arena_frac=0.5))
        rd0, fa0 = rd.launches, fa.launches
        for p in prompts:
            eng.submit(p, max_new_tokens=12)
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
        streams[kern] = eng.results()
        decode_steps = eng._obs.registry.histogram_at("decode_step_s").count
        if kern:
            # each decode step replays its graph (the layers' launches);
            # each capture ran _WARMUP eager steps before it
            n = rd.launches - rd0
            assert n % cfg.num_layers == 0
            assert cfg.num_layers <= n <= cfg.num_layers * (
                decode_steps + _WARMUP * eng.graph_captures)
            assert fa.launches - fa0 >= cfg.num_layers * len(prompts)
        else:
            assert (rd.launches, fa.launches) == (rd0, fa0)
    assert streams[True] == streams[False]


def _mamba_case(cuda, dtype, d_model, N, B, seed=4):
    """A reduced falcon-mamba block at ``d_model`` and state dim ``N``,
    and a step's inputs for ``B`` slots."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import ssm as S

    base = get_reduced("falcon-mamba-7b")
    cfg = dataclasses.replace(base, d_model=d_model, ssm=dataclasses.replace(
        base.ssm, state_dim=N))
    d_in, _, _, w = S.dims(cfg)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = S.mamba_init(gen, cfg, dtype=dtype, device=cuda)
    args = [p[k] for k in MAMBA_ORDER]
    x1 = torch.randn((B, 1, d_model), generator=gen, device=cuda).to(dtype)
    conv0 = torch.randn((B, w - 1, d_in), generator=gen, device=cuda).to(dtype)
    h0 = torch.randn((B, d_in, N), generator=gen, device=cuda) * 0.5
    return args, x1, conv0, h0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d_model,N", [(256, 16), (64, 4), (96, 8)])
@pytest.mark.parametrize("B", [1, 8, 11, 16, 40])
def test_mamba_step_kernel_on_gpu(cuda, dtype, d_model, N, B):
    """Widths whose x_proj columns (dt_rank + 2N) or dt_proj rows are no
    multiple of 16 bytes take the CUDA-core product (64 and 96); at 256
    every bf16 product runs on the tensor cores, in_proj unsplit and
    out_proj split.  B = 11 and 16 take two n-tiles of 8 slot rows in one
    pass over the weights, B = 40 two passes.  Slot 1 is dead (B > 1):
    zero output, conv and h bit-unchanged."""
    args, x1, conv0, h0 = _mamba_case(cuda, dtype, d_model, N, B)
    live = torch.ones(B, dtype=torch.bool, device=cuda)
    if B > 1:
        live[1] = False
    conv, h = conv0.clone(), h0.clone()
    before = ms.step_launches
    out = ms.mamba_step(x1, conv, h, *args, live=live)
    want = mamba_step_ref(x1, conv0, h0, *args, live=live)
    torch.cuda.synchronize()
    assert ms.step_launches == before + 1
    for got, ref in zip((out, conv, h), want):
        assert _agree(got, ref, GPU_TOL[dtype])
    if B > 1:
        assert (out[1] == 0).all()
        assert torch.equal(conv[1], conv0[1]) and torch.equal(h[1], h0[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 8])
def test_mamba_step_kernel_at_hymba_widths(cuda, dtype, B):
    """hymba-1.5b's Mamba block: d_model 1600, d_in 3200, dt_rank 100, N
    16.  x_proj (3200 x 132) and dt_proj (100 x 3200) are no multiple of 8
    wide or deep, so they take the CUDA-core product; slot 1 is dead."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S

    cfg = get_config("hymba-1.5b")
    d_in, R, N, w = S.dims(cfg)
    assert (d_in, R, N) == (3200, 100, 16)
    gen = torch.Generator(device=cuda).manual_seed(6)
    p = S.mamba_init(gen, cfg, dtype=dtype, device=cuda)
    args = [p[k] for k in MAMBA_ORDER]
    x1 = torch.randn((B, 1, cfg.d_model), generator=gen,
                     device=cuda).to(dtype)
    conv0 = torch.randn((B, w - 1, d_in), generator=gen, device=cuda).to(dtype)
    h0 = torch.randn((B, d_in, N), generator=gen, device=cuda) * 0.5
    live = torch.ones(B, dtype=torch.bool, device=cuda)
    if B > 1:
        live[1] = False
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    x_plan = ms._product_plan(B, d_in, R + 2 * N, d_in, 0, p["x_proj"], sms)
    dt_plan = ms._product_plan(B, R, d_in, R + 2 * N, 0, p["dt_proj"], sms)
    assert x_plan.route == dt_plan.route == ms._FMA
    conv, h = conv0.clone(), h0.clone()
    before = ms.step_launches
    out = ms.mamba_step(x1, conv, h, *args, live=live)
    want = mamba_step_ref(x1, conv0, h0, *args, live=live)
    torch.cuda.synchronize()
    assert ms.step_launches == before + 1
    for got, ref in zip((out, conv, h), want):
        assert _agree(got, ref, GPU_TOL[dtype])
    if B > 1:
        assert (out[1] == 0).all()
        assert torch.equal(conv[1], conv0[1]) and torch.equal(h[1], h0[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_step_kernel_is_deterministic(cuda, dtype, monkeypatch):
    """Two calls on the same inputs give bitwise-equal outputs and states
    (split partials are summed in a fixed order, no atomics), with the
    launches overlapped or not.  d_model 1024 splits in_proj and out_proj
    on the tensor cores."""
    args, x1, conv0, h0 = _mamba_case(cuda, dtype, 1024, 16, 8)
    live = torch.ones(8, dtype=torch.bool, device=cuda)
    live[3] = False
    runs = []
    for ov in (True, True, False):
        monkeypatch.setattr(ms, "overlap", ov)
        conv, h = conv0.clone(), h0.clone()
        out = ms.mamba_step(x1, conv, h, *args, live=live)
        torch.cuda.synchronize()
        runs.append((out, conv, h))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.gpu
@pytest.mark.parametrize("d_model", [256, 1024])
def test_mamba_step_back_to_back_equals_synchronized(cuda, d_model):
    """Two steps with different inputs queued back to back on one stream
    (the second's launches may start while the first's run) equal the same
    two steps with a synchronize between them, bit for bit: no launch
    writes scratch or state that the launch before still reads."""
    args, x1, conv0, h0 = _mamba_case(cuda, torch.bfloat16, d_model, 16, 8)
    x2 = torch.randn(x1.shape, generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda).to(x1.dtype)
    live = torch.ones(8, dtype=torch.bool, device=cuda)
    live[5] = False
    results = []
    for sync in (False, True):
        conv, h = conv0.clone(), h0.clone()
        torch.cuda.synchronize()
        a = ms.mamba_step(x1, conv, h, *args, live=live)
        if sync:
            torch.cuda.synchronize()
        b = ms.mamba_step(x2, conv, h, *args, live=live)
        torch.cuda.synchronize()
        results.append((a, b, conv, h))
    assert all(torch.equal(p, q) for p, q in zip(*results))
    assert not torch.equal(results[0][0], results[0][1])


def _scan_case(cuda, dtype, B, S, D, N, R, seed=5):
    """x, dt, B and C (strided views of one (B, S, R + 2N) dbc tensor: at
    R = 6 in bf16 B starts 12 bytes into a row, at R = 256 16-byte
    aligned), A_log and D."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((B, S, D), generator=gen, device=cuda).to(dtype)
    delta = softplus(torch.randn((B, S, D), generator=gen, device=cuda) - 3)
    dbc = torch.randn((B, S, R + 2 * N), generator=gen, device=cuda).to(dtype)
    a_log = torch.log(torch.rand((D, N), generator=gen, device=cuda) * 4 + 0.5)
    d = torch.randn(D, generator=gen, device=cuda)
    return x, delta, dbc[..., R:R + N], dbc[..., R + N:], a_log, d


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 37, 63, 64, 65, 129, 200, 1000])
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("D", [80, 8192])
@pytest.mark.parametrize("R", [6, 256])
def test_mamba_scan_kernel_on_gpu(cuda, dtype, S, N, B, D, R):
    """S at the 64-step staging tile's edges and past it; d_in = 80 (no
    multiple of the 64-channel block) and falcon's 8192; B and C as
    unaligned (R = 6) and aligned (R = 256) views."""
    ins = _scan_case(cuda, dtype, B, S, D, N, R)
    before = ms.scan_launches
    y, h = ms.mamba_scan(*ins)
    want_y, want_h = mamba_scan_ref(*ins)
    torch.cuda.synchronize()
    assert ms.scan_launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    assert _agree(y, want_y, 1e-4) and _agree(h, want_h, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [6, 256])
def test_mamba_scan_kernel_is_deterministic(cuda, dtype, R):
    """No atomics: two calls on the same inputs are bit-equal."""
    ins = _scan_case(cuda, dtype, 1, 1000, 8192, 16, R)
    y1, h1 = ms.mamba_scan(*ins)
    y2, h2 = ms.mamba_scan(*ins)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def _close_scaled(got, want, tol):
    """max |got - want| within tol of want's largest magnitude, and got
    finite: sums over thousands of channels or steps cancel, so an
    element's own size is no scale for its error."""
    g, w = got.float(), want.float()
    scale = max(w.abs().max().item(), 1e-6)
    return bool((g - w).abs().max().item() <= tol * scale
                and g.isfinite().all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 33, 1000])
@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("B,D", [(1, 80), (2, 3200)])
@pytest.mark.parametrize("R", [6, 256])
def test_mamba_scan_bwd_kernel_on_gpu(cuda, dtype, S, N, B, D, R):
    """The training forward (the scan with its boundary states) and the
    scan's backward against the plain pair: the training instance's y and
    last state equal the serving instance's bitwise, its bounds agree
    with the plain forward's, and (dx, ddt, dB, dC, dA, dD) with the plain
    backward's on the kernel's bounds; fp32 sums in both, bf16 outputs
    held to a few bf16 ulps of the tensor's scale."""
    from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_fwd_ref)
    ins = _scan_case(cuda, dtype, B, S, D, N, R)
    gy = torch.randn((B, S, D), generator=torch.Generator(
        device=cuda).manual_seed(S), device=cuda)
    before = (ms.scan_launches, ms.scan_train_launches, ms.scan_bwd_launches)
    y, h, bounds = ms.mamba_scan(*ins, bounds=True)
    y_s, h_s = ms.mamba_scan(*ins)
    got = ms.mamba_scan_bwd(*ins, bounds, gy)
    want_y, want_b = selective_scan_fwd_ref(*ins)
    want = selective_scan_bwd_ref(*ins, bounds, gy)
    torch.cuda.synchronize()
    assert (ms.scan_launches, ms.scan_train_launches,
            ms.scan_bwd_launches) == tuple(n + 1 for n in before)
    assert torch.equal(y, y_s) and torch.equal(h, h_s)
    assert bounds.shape == want_b.shape
    assert _agree(y, want_y, 1e-4) and _agree(bounds, want_b, 1e-4)
    for name, g, w in zip(("dx", "ddt", "db", "dc", "dA", "dD"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = GPU_TOL[dtype] if g.dtype == torch.bfloat16 else 1e-4
        assert _close_scaled(g, w, tol), (name, (g.float() - w.float())
                                          .abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_scan_bwd_is_deterministic(cuda, dtype):
    """No atomics: the backward at falcon-mamba-7b's training layer (B 4,
    S 1024, d_in 8192, N 16) repeats bitwise, as the forward's boundary
    states do."""
    ins = _scan_case(cuda, dtype, 4, 1024, 8192, 16, 256)
    gy = torch.randn((4, 1024, 8192), generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    fwd = [ms.mamba_scan(*ins, bounds=True) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    runs = [ms.mamba_scan_bwd(*ins, fwd[0][2], gy) for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.gpu
def test_selective_scan_autograd_on_gpu_matches_plain(cuda):
    """``ssm.fused_selective_scan`` under autograd on the card (the
    kernels) against the same Function's plain pair (``use_kernels``
    False), bf16 at hymba's widths; B and C as views of one dbc."""
    from repro_torch.models import ssm as S
    ins = _scan_case(cuda, torch.bfloat16, 2, 300, 3200, 16, 100)
    x, dt, _, _, a_log, d = ins
    dbc = ins[2]._base
    gy = torch.randn((2, 300, 3200), generator=torch.Generator(
        device=cuda).manual_seed(4), device=cuda)
    grads = []
    before = ms.scan_bwd_launches
    for use_kernels in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, dbc, a_log,
                                                           d)]
        y = S.fused_selective_scan(leaves[0], leaves[1],
                                   leaves[2][..., 100:116],
                                   leaves[2][..., 116:], leaves[3],
                                   leaves[4], use_kernels=use_kernels)
        y.backward(gy)
        grads.append([y.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    assert ms.scan_bwd_launches == before + 1
    for a, b in zip(*grads):
        tol = GPU_TOL[torch.bfloat16] if a.dtype == torch.bfloat16 else 1e-4
        assert _close_scaled(a, b, tol)


@pytest.mark.gpu
def test_mamba_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 4, 32), dtype=torch.float16, device=cuda)
    dt = torch.zeros((1, 4, 32), device=cuda)
    b = torch.zeros((1, 4, 16), dtype=torch.float16, device=cuda)
    a_log = torch.zeros((32, 16), device=cuda)
    d = torch.zeros(32, device=cuda)
    with pytest.raises(TypeError):
        ms.mamba_scan(x, dt, b, b, a_log, d)
    b5 = torch.zeros((1, 4, 5), device=cuda)
    with pytest.raises(ValueError):
        ms.mamba_scan(x.float(), dt, b5, b5, a_log[:, :5].contiguous(), d)


@pytest.mark.gpu
def test_ssm_engine_on_gpu_kernel_path_matches_plain_path(cuda):
    """The SSM engine on the card, reduced falcon-mamba in fp32: streams
    with both Mamba kernels on equal the plain path's, and every layer of
    every prefill and decode step launched its kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.models.model import Model
    from repro_torch.workloads import SSMEngine, ServeConfig

    cfg = dataclasses.replace(get_reduced("falcon-mamba-7b"), dtype="float32")
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n))
               for n in rng.integers(3, 40, size=5)]
    streams = {}
    for kern in (True, False):
        eng = SSMEngine(model, params, ServeConfig(
            max_slots=3, max_len=16, eos_id=-1, use_kernels=kern))
        st0, sc0 = ms.step_launches, ms.scan_launches
        for p in prompts:
            eng.submit(p, max_new_tokens=12)
        while eng.has_work:
            eng.step()
        streams[kern] = eng.results()
        decode_steps = eng._obs.registry.histogram_at("decode_step_s").count
        if kern:
            # each decode step replays its graph (the layers' launches);
            # each capture ran _WARMUP eager steps before it
            assert ms.step_launches - st0 == cfg.num_layers * (
                decode_steps + _WARMUP * eng.graph_captures)
            assert ms.scan_launches - sc0 == cfg.num_layers * len(prompts)
        else:
            assert (ms.step_launches, ms.scan_launches) == (st0, sc0)
    assert streams[True] == streams[False]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flex_mm_kernel_random_dims_one_buffer(cuda, dtype):
    """One compiled kernel, one 192^3 buffer, many (m, k, n): each against
    the plain version, zeros outside the valid region."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.rand((192, 192), generator=gen, device=cuda).to(dtype) - 0.5
    b = torch.rand((192, 192), generator=gen, device=cuda).to(dtype) - 0.5
    rng = torch.Generator().manual_seed(6)
    shapes = torch.randint(0, 193, (40, 3), generator=rng).tolist()
    shapes += [[1, 1, 1], [192, 192, 192], [129, 8, 127], [0, 5, 5]]
    before = fm.launches
    for mkn in shapes:
        dims = torch.tensor(mkn, dtype=torch.int32, device=cuda)
        got = fm.flex_mm(a, b, dims)
        want = flex_mm_ref(a, b, dims)
        m, _, n = mkn
        assert _agree(got, want, GPU_TOL[dtype]), mkn
        assert (got[m:] == 0).all() and (got[:, n:] == 0).all(), mkn
    torch.cuda.synchronize()
    assert fm.launches == before + len(shapes)


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", [(40, 50, 60), (300, 200, 400), (0, 7, 9),
                                 (1, 1, 1), (130, 0, 257)])
def test_flex_mm_kernel_dead_tiles_write_zeros(cuda, mkn):
    """The output buffer starts as NaN: every dead tile and every masked
    edge must come back zero, the valid region equal to the plain
    version's; NaN in both paddings stays out."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    a = torch.rand((300, 200), generator=gen, device=cuda) - 0.5
    b = torch.rand((200, 400), generator=gen, device=cuda) - 0.5
    m, k, n = mkn
    want = flex_mm_ref(a, b, list(mkn))
    a[:, k:] = float("nan")
    b[k:, :] = float("nan")
    out = torch.full((300, 400), float("nan"), device=cuda)
    dims = torch.tensor(mkn, dtype=torch.int32, device=cuda)
    assert fm.flex_mm(a, b, dims, out=out) is out
    torch.cuda.synchronize()
    assert out.isfinite().all()
    assert (out[m:] == 0).all() and (out[:, n:] == 0).all()
    assert _agree(out, want, GPU_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flex_mm_kernel_strided_windows(cuda, dtype):
    """Windows of a flat buffer with row strides that are no multiple of 4
    (scalar path) and that are (vector path) take no copy."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    flat = torch.rand(40000, generator=gen, device=cuda).to(dtype) - 0.5
    for cols, (r, c) in ((37, (50, 30)), (64, (70, 64))):
        a = flat.as_strided((r, c), (cols, 1), 3)
        b = flat.as_strided((c, 45), (48, 1), 20000)
        out = torch.empty((r, 45), dtype=dtype, device=cuda)
        dims = torch.tensor([r, c, 45], dtype=torch.int32, device=cuda)
        fm.flex_mm(a, b, dims, out=out)
        assert _agree(out, flex_mm_ref(a, b, dims), GPU_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_static_mm_kernel_on_gpu(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(9)
    a = torch.rand((260, 130), generator=gen, device=cuda).to(dtype) - 0.5
    b = torch.rand((130, 200), generator=gen, device=cuda).to(dtype) - 0.5
    before = fm.static_launches
    got = fm.static_mm(a, b)
    torch.cuda.synchronize()
    assert fm.static_launches == before + 1
    assert _agree(got, static_mm_ref(a, b), GPU_TOL[dtype])


# BERT-128's CU passes on the paper path (m, k, n): the port's DSE with
# the example's settings gives 309 passes in these 18 shapes
BERT128_PASS_SHAPES = (
    (16, 768, 768), (16, 768, 3072), (16, 3072, 768), (32, 768, 768),
    (32, 3072, 768), (64, 768, 768), (64, 768, 3072), (64, 3072, 768),
    (128, 768, 768), (128, 768, 3072), (128, 3072, 768), (192, 128, 64),
    (384, 64, 128), (384, 128, 64), (768, 64, 128), (768, 128, 64),
    (1536, 64, 128), (1536, 128, 64))


def _pass_operands(gen, m, k, n, device, dtype=torch.float32):
    """Operands scaled as the DDR image scales them: the input N(0, 1), the
    weight N(0, 1) / sqrt(k)."""
    a = torch.randn((m, k), generator=gen, device=device)
    b = torch.randn((k, n), generator=gen, device=device) / k ** 0.5
    return a.to(dtype), b.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", BERT128_PASS_SHAPES)
def test_flex_mm_kernel_bert128_pass_shapes(cuda, mkn):
    """Each pass shape with the buffer exactly the pass, as the simulator
    hands the windows over: the plan's tile and splits, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    a, b = _pass_operands(gen, *mkn, cuda)
    dims = torch.tensor(mkn, dtype=torch.int32, device=cuda)
    out = torch.full((mkn[0], mkn[2]), float("nan"), device=cuda)
    before = fm.launches
    fm.flex_mm(a, b, dims, out=out)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    assert _agree(out, flex_mm_ref(a, b, dims), GPU_TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("where", ["inside_a_split", "on_a_split_edge",
                                   "before_the_last_split", "at_the_end",
                                   "zero", "inside_the_first_step"])
def test_flex_mm_kernel_split_k_runtime_k(cuda, dtype, where):
    """A (16, 768, 768) buffer plans several splits of kspan: a runtime k
    that ends inside a split, on a split's edge, two splits before the
    last (the later splits hold nothing), at the end, at 0 and inside the
    first k-step; NaN in both paddings beyond k, Inf beyond m and n."""
    Mx, Kx, Nx = 16, 768, 768
    _, _, bk, splits = fm.plan(Mx, Kx, Nx)
    kspan = fm.split_span(Kx, bk, splits)
    assert splits > 3
    k = {"inside_a_split": kspan + 7, "on_a_split_edge": 2 * kspan,
         "before_the_last_split": (splits - 2) * kspan - 5,
         "at_the_end": Kx, "zero": 0, "inside_the_first_step": 5}[where]
    gen = torch.Generator(device=cuda).manual_seed(12)
    a, b = _pass_operands(gen, Mx, Kx, Nx, cuda, dtype)
    m, n = 13, 700
    want = flex_mm_ref(a, b, [m, k, n])
    a[:, k:] = float("nan")
    b[k:, :] = float("nan")
    a[m:, :] = float("inf")
    b[:, n:] = float("-inf")
    out = torch.full((Mx, Nx), float("nan"), dtype=dtype, device=cuda)
    fm.flex_mm(a, b, torch.tensor([m, k, n], dtype=torch.int32,
                                  device=cuda), out=out)
    torch.cuda.synchronize()
    assert (out[m:] == 0).all() and (out[:, n:] == 0).all()
    assert _agree(out, want, GPU_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flex_mm_kernel_unaligned_windows_split_k(cuda, dtype):
    """FMU windows whose rows are not 16-byte aligned (cols 771 and 37:
    4-byte copies in fp32, plain loads in bf16) at a split-K plan."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    flat = torch.randn(80000, generator=gen, device=cuda).to(dtype)
    a = flat.as_strided((16, 768), (771, 1), 1)
    b = flat.as_strided((768, 37), (37, 1), 20001) / 768 ** 0.5
    out = torch.full((16, 37), float("nan"), dtype=dtype, device=cuda)
    dims = torch.tensor([16, 768, 37], dtype=torch.int32, device=cuda)
    assert fm.plan(16, 768, 37)[3] > 1
    fm.flex_mm(a, b, dims, out=out)
    torch.cuda.synchronize()
    assert _agree(out, flex_mm_ref(a, b, dims), GPU_TOL[dtype])


@pytest.mark.gpu
def test_flex_mm_split_tickets_back_at_zero_and_per_stream(cuda):
    """Every split launch leaves its stream's tickets at zero, and a
    launch on a second stream uses that stream's own scratch."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    a, b = _pass_operands(gen, 16, 3072, 768, cuda)
    dims = torch.tensor([16, 3072, 768], dtype=torch.int32, device=cuda)
    want = flex_mm_ref(a, b, dims)
    side = torch.cuda.Stream(device=cuda)
    outs = []
    for stream in (torch.cuda.current_stream(cuda), side):
        with torch.cuda.stream(stream):
            for _ in range(3):
                outs.append(fm.flex_mm(a, b, dims))
        stream.synchronize()
        tickets, _ = fm._scratch[(cuda.index or 0, stream.cuda_stream)]
        assert (tickets == 0).all()
    for out in outs:
        assert torch.equal(out, outs[0])      # split order is fixed
    assert _agree(outs[0], want, GPU_TOL[torch.float32])


@pytest.mark.gpu
def test_flex_mm_never_syncs_on_dims(cuda):
    """The wrapper reads no device value on the host: the dims stay on
    the card (the paper's runtime instruction)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    a, b = _pass_operands(gen, 64, 768, 3072, cuda)
    imem = torch.tensor([[64, 768, 3072], [40, 500, 1000]],
                        dtype=torch.int32, device=cuda)
    outs = [torch.empty((64, 3072), device=cuda) for _ in range(2)]
    fm.flex_mm(a, b, imem[0], out=outs[0])      # scratch allocated here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for p in range(2):
            fm.flex_mm(a, b, imem[p], out=outs[p])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for p in range(2):
        assert _agree(outs[p], flex_mm_ref(a, b, imem[p]),
                      GPU_TOL[torch.float32])


@pytest.mark.gpu
def test_filco_mm_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    a = torch.zeros((8, 8), dtype=torch.float16, device=cuda)
    dims = torch.tensor([8, 8, 8], dtype=torch.int32, device=cuda)
    before = fm.launches
    with pytest.raises(TypeError):
        fm.flex_mm(a, a, dims)                      # fp16
    f = a.float()
    with pytest.raises(TypeError):
        fm.flex_mm(f, f, dims.long())               # int64 dims
    with pytest.raises(ValueError):
        fm.flex_mm(f, f.cpu(), dims)                # two devices
    with pytest.raises(ValueError):
        fm.flex_mm(f, f, dims.cpu())                # dims on the host
    with pytest.raises(ValueError):
        fm.flex_mm(f.t(), f, dims)                  # column stride
    with pytest.raises(ValueError):
        fm.flex_mm(f, f, dims, out=torch.empty((8, 4), device=cuda))
    with pytest.raises(TypeError):
        fm.static_mm(f, f.to(torch.bfloat16))
    assert fm.launches == before


@pytest.mark.gpu
def test_simulator_on_gpu_matches_cpu(cuda):
    """The data-plane simulator on the card, every CU pass through the
    kernel, against the same program on the CPU's plain path."""
    from repro_torch.configs.paper_workloads import POINTNET_S
    from repro_torch.core.analytical import filco_vck190
    from repro_torch.core.codegen import generate
    from repro_torch.core.dse import run_dse
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.simulator import DataPlaneSim, cu_pass_dims
    from repro_torch.launch.dse_to_silicon import ddr_image

    accel = filco_vck190()
    res = run_dse(POINTNET_S, accel, solver="ga", max_modes=4,
                  ga_config=GAConfig(population=16, generations=12, seed=0))
    prog = generate(POINTNET_S, res.plan)
    image = torch.from_numpy(ddr_image(POINTNET_S, prog.layout, 0))
    cap = max(max(l.m * l.k, l.k * l.n, l.m * l.n) for l in POINTNET_S.layers)
    ddr = {}
    for dev in (cuda, "cpu"):
        sim = DataPlaneSim(image.numel(), accel.num_fmus, cap,
                           accel.num_cus, device=dev)
        sim.ddr.copy_(image)
        before = fm.launches
        sim.run(prog)
        ddr[str(dev)] = sim.ddr.cpu()
        passes = len(cu_pass_dims(prog))
        assert fm.launches - before == (passes if dev == cuda else 0)
    assert _agree(ddr[str(cuda)], ddr["cpu"], 1e-5)
