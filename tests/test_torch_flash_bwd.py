"""The port's flash attention with a gradient against the reference's
``layers.blockwise_attention`` custom VJP.

The plain autograd Function (``repro_torch.models.layers.blockwise_attention``
and ``flash_forward`` / ``flash_backward``) gets the same numpy-seeded q, k,
v and output gradient as the reference: ``out`` and ``lse`` against
``_flash_fwd_pass``, and (dq, dk, dv) against ``jax.vjp`` of
``blockwise_attention``, over the whole contract (causal, bidirectional,
GQA, multi-query, S no multiple of the block, a window with a global
layer, a logit cap, per-row key lengths), and bidirectional attention
over keys of another length than the queries (cross-attention, Skv !=
Sq).  fp32: within 1e-5 of each tensor's largest magnitude (summation
order only); bf16: within 2e-2 (the two round p and ds to bf16 at the
same points, but sum in other orders).

On the CPU the kernel wrappers (``flash_attention_lse``,
``flash_attention_bwd``, and ``flash_attention`` under autograd) take
these plain versions; the GPU tests hold the kernels to them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

FP32_TOL = 1e-5
BF16_TOL = 2e-2

# (name, B, S, Hq, Hkv, D, kwargs of blockwise_attention)
CASES = [
    ("causal", 2, 32, 4, 2, 16, dict(causal=True)),
    ("bidirectional", 2, 32, 4, 2, 16, dict(causal=False)),
    ("mqa", 1, 32, 4, 1, 16, dict(causal=True)),
    ("ragged_blocks", 1, 40, 4, 2, 8, dict(causal=True, block_size=16)),
    ("window", 1, 40, 4, 2, 8, dict(causal=True, window=12,
                                    block_size=16)),
    ("window_global", 1, 40, 4, 2, 8, dict(causal=True, window=12,
                                           block_size=16, is_global=True)),
    ("logit_cap", 2, 32, 4, 2, 16, dict(causal=True, logit_cap=5.0)),
    ("kv_len", 2, 40, 4, 2, 8, dict(causal=False, block_size=16,
                                    kv_len=np.array([40, 23], np.int32))),
    ("q_offset", 1, 24, 4, 2, 8, dict(causal=True, q_offset=8,
                                      block_size=16)),
]


def _inputs(B, S, Hq, Hkv, D, seed=0, Skv=None):
    """q and the output gradient (B, S, Hq, D), k and v (B, Skv, Hkv, D)
    (Skv None: S)."""
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    g = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    return q, k, v, g


def _jax_kw(kw):
    out = dict(kw)
    if "kv_len" in out:
        out["kv_len"] = jnp.asarray(out["kv_len"])
    return out


def _torch_kw(kw):
    out = dict(kw)
    if "kv_len" in out:
        out["kv_len"] = torch.as_tensor(out["kv_len"])
    return out


def _close(got, want, tol):
    got = np.asarray(got.float() if hasattr(got, "float") else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _reference(q, k, v, g, kw, dtype):
    jq, jk, jv, jg = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    jkw = _jax_kw(kw)

    def fwd_bwd(a, b, c, g):
        out, vjp = jax.vjp(
            lambda a, b, c: JL.blockwise_attention(a, b, c, **jkw), a, b, c)
        return (out,) + vjp(g)

    out, dq, dk, dv = jax.jit(fwd_bwd)(jq, jk, jv, jg)
    # lse from the reference's forward pass on whole blocks
    Skv = k.shape[1]
    bs = min(kw.get("block_size", 512), Skv)
    pad = -(-Skv // bs) * bs - Skv
    kp = jnp.pad(jk, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = jnp.pad(jv, ((0, 0), (0, pad), (0, 0), (0, 0)))
    valid = jnp.asarray(Skv if "kv_len" not in kw else jkw["kv_len"])
    is_global = kw.get("is_global")
    _, lse = JL._flash_fwd_pass(
        kw["causal"], kw.get("window", 0), bs, kw.get("logit_cap", 0.0),
        jq, kp, vp, jnp.asarray(kw.get("q_offset", 0)), valid,
        None if is_global is None else jnp.asarray(is_global))
    return [np.asarray(jnp.asarray(t, jnp.float32))
            for t in (out, lse, dq, dk, dv)]


def _port(q, k, v, g, kw, dtype):
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    tkw = _torch_kw(kw)
    out = L.blockwise_attention(tq, tk, tv, **tkw)
    out.backward(torch.tensor(g).to(dtype))
    with torch.no_grad():
        _, lse = L.flash_forward(tq, tk, tv, **tkw)
    return out.detach(), lse, tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("name,B,S,Hq,Hkv,D,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_flash_grads_match_reference_fp32(name, B, S, Hq, Hkv, D, kw):
    q, k, v, g = _inputs(B, S, Hq, Hkv, D)
    want = _reference(q, k, v, g, kw, jnp.float32)
    got = _port(q, k, v, g, kw, torch.float32)
    for what, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        if what == "lse" and "kv_len" in kw:
            # a row's padded keys are -1e30 scores on both sides; compare
            # its valid rows' lse only where they are finite sums
            b = np.where(b < -1e29, 0.0, b)
            a = torch.where(a < -1e29, 0.0, a)
        _close(a, b, FP32_TOL)


@pytest.mark.parametrize("name", ["causal", "mqa", "ragged_blocks"])
def test_plain_flash_grads_match_reference_bf16(name):
    _, B, S, Hq, Hkv, D, kw = next(c for c in CASES if c[0] == name)
    q, k, v, g = _inputs(B, S, Hq, Hkv, D, seed=1)
    want = _reference(q, k, v, g, kw, jnp.bfloat16)
    got = _port(q, k, v, g, kw, torch.bfloat16)
    for a, b in zip(got, want):
        _close(a, b, BF16_TOL)


# bidirectional attention over keys of another length (cross-attention):
# (name, B, Sq, Skv, Hq, Hkv, D, kwargs of blockwise_attention)
CROSS_CASES = [
    ("longer_keys", 2, 24, 40, 4, 2, 16, dict(causal=False)),
    ("shorter_keys", 1, 40, 16, 4, 4, 8, dict(causal=False, block_size=16)),
    ("mqa_ragged_blocks", 1, 33, 70, 4, 1, 8, dict(causal=False,
                                                  block_size=32)),
]


@pytest.mark.parametrize("name,B,Sq,Skv,Hq,Hkv,D,kw", CROSS_CASES,
                         ids=[c[0] for c in CROSS_CASES])
def test_plain_flash_cross_lengths_match_reference_fp32(name, B, Sq, Skv, Hq,
                                                        Hkv, D, kw):
    """Skv != Sq: out, lse and (dq, dk, dv) of the plain Function against
    the reference's ``_flash_fwd_pass`` and ``jax.vjp`` of
    ``blockwise_attention``."""
    q, k, v, g = _inputs(B, Sq, Hq, Hkv, D, seed=Skv, Skv=Skv)
    want = _reference(q, k, v, g, kw, jnp.float32)
    got = _port(q, k, v, g, kw, torch.float32)
    for what, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == b.shape, what
        _close(a, b, FP32_TOL)


@pytest.mark.parametrize("name", ["longer_keys", "shorter_keys"])
def test_plain_flash_cross_lengths_match_reference_bf16(name):
    _, B, Sq, Skv, Hq, Hkv, D, kw = next(c for c in CROSS_CASES
                                         if c[0] == name)
    q, k, v, g = _inputs(B, Sq, Hq, Hkv, D, seed=Sq, Skv=Skv)
    want = _reference(q, k, v, g, kw, jnp.bfloat16)
    got = _port(q, k, v, g, kw, torch.bfloat16)
    for a, b in zip(got, want):
        _close(a, b, BF16_TOL)


def test_cpu_wrappers_take_cross_lengths():
    """On CPU tensors the wrappers at Skv != Sq give the plain Function's
    numbers (under autograd, and the lse forward with the backward on its
    out and lse), the split fold matches the unsplit plain backward, and
    nothing launches."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_bwd_split_ref)
    q, k, v, g = (torch.tensor(a) for a in
                  _inputs(2, 24, 4, 2, 16, seed=4, Skv=40))
    before = dict(fa.__dict__)
    grads = []
    for fn in (fa.flash_attention, L.blockwise_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, causal=False).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    out, lse = fa.flash_attention_lse(q, k, v, causal=False)
    assert lse.shape == (2, 24, 4)
    got = fa.flash_attention_bwd(q, k, v, out, g, lse, causal=False)
    for a, b in zip(got, grads[0]):
        assert torch.equal(a, b)
    plain = flash_attention_bwd_ref(q, k, v, out, g, lse, causal=False)
    split = flash_attention_bwd_split_ref(q, k, v, out, g, lse,
                                          causal=False, n_split=2)
    for a, b in zip(split, plain):
        _close(a, b.numpy(), FP32_TOL)
    assert {n: fa.__dict__[n] for n in before if n.endswith("launches")} \
        == {n: v for n, v in before.items() if n.endswith("launches")}


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=False, window=8),
                                dict(causal=False, kv_len=True)],
                         ids=["causal", "window", "kv_len"])
def test_kernel_contract_cross_lengths(kw):
    """The kernels take Skv != Sq only bidirectional without a window or
    key padding (the check runs before any launch; a global layer's
    window is no window); Skv = S takes every mask."""
    q = torch.zeros((1, 24, 4, 16))
    k = torch.zeros((1, 40, 2, 16))
    kv_len = torch.full((1,), 30, dtype=torch.int32) if "kv_len" in kw \
        else None
    with pytest.raises(ValueError, match="Skv != S"):
        fa._check(q, k, k, kv_len, kw.get("window", 0), None, kw["causal"])
    # past the length check, the device check raises on CPU tensors
    for args in ((q, k, k, None, kw.get("window", 0), True, False),
                 (q, k[:, :24], k[:, :24], kv_len, kw.get("window", 0), None,
                  kw["causal"])):
        with pytest.raises(ValueError, match="CUDA"):
            fa._check(*args)


def test_blockwise_forward_unchanged_without_grad():
    """No autograd: the same forward numbers as with it."""
    q, k, v, _ = _inputs(2, 40, 4, 2, 8, seed=2)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    with torch.no_grad():
        plain = L.blockwise_attention(tq, tk, tv, causal=True, block_size=16)
    graded = L.blockwise_attention(tq.requires_grad_(True), tk, tv,
                                   causal=True, block_size=16)
    assert torch.equal(plain, graded.detach())


def test_cpu_wrappers_take_the_plain_versions():
    """The kernel wrappers on CPU tensors: ``flash_attention`` under
    autograd, ``flash_attention_lse`` and ``flash_attention_bwd`` give the
    plain Function's numbers, and launch nothing."""
    q, k, v, g = _inputs(1, 40, 4, 2, 16, seed=3)
    tg = torch.tensor(g)
    before = (fa.lse_launches, fa.bwd_launches, fa.launches)
    grads = []
    for fn in (fa.flash_attention, lambda a, b, c, **kw:
               L.blockwise_attention(a, b, c, **kw)):
        tq, tk, tv = (torch.tensor(a).requires_grad_(True) for a in (q, k, v))
        fn(tq, tk, tv, causal=True).backward(tg)
        grads.append((tq.grad, tk.grad, tv.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    out, lse = fa.flash_attention_lse(tq, tk, tv, causal=True)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, out, tg, lse,
                                        causal=True)
    for a, b in zip((dq, dk, dv), grads[0]):
        assert torch.equal(a, b)
    assert (fa.lse_launches, fa.bwd_launches, fa.launches) == before


def test_kernel_contract_raises_before_launch():
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    for kw in (dict(logit_cap=5.0),
               dict(kv_len=torch.ones(1, dtype=torch.int32))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fa._check_bwd(q, kw.get("logit_cap", 0.0), kw.get("kv_len"))
    fa._check_bwd(q, 0.0, None)         # a sliding window goes through
    fa._check_bwd(torch.zeros((1, 8, 2, 192)), 0.0, None)  # MLA
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa._check_bwd(torch.zeros((1, 8, 2, 256)), 0.0, None)


# ---------------------------------------------------------------------------
# the backward kernel's split of a KV head's query heads (ops.bwd_plan) and
# its fold of the fp32 partials (ref.flash_attention_bwd_split_ref)
# ---------------------------------------------------------------------------

def _bwd_cases():
    """``chip_smoke.BWD_CASES``: the shapes the card runs the kernel at."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.BWD_CASES


H100_SMS = 132


@pytest.mark.parametrize("case", _bwd_cases(), ids=lambda c: c[0])
def test_bwd_plan_fills_the_card(case):
    label, B, S, Hq, Hkv, D, causal = case
    G = Hq // Hkv
    n = fa.bwd_plan(B, S, Hq, Hkv, H100_SMS, D)
    assert G % n == 0
    blocks = B * Hkv * -(-S // 64)
    # one 8-warp dK/dV block fits an SM above head dim 128, two below
    per_sm = fa._BWD_BLOCKS_PER_SM if D <= 128 else 1
    target = per_sm * H100_SMS
    # the target met, or every head split off; by the least such divisor
    assert blocks * n >= target or n == G
    assert all(blocks * m < target for m in range(1, n) if G % m == 0)
    if label == "minitron":
        assert n == 1                         # 4 x 8 x 16 = 512 blocks
    if label == "granite MQA":
        assert n > 1                          # 16 blocks unsplit
    if label == "MLA":
        assert n == 1                         # G = 1: 1024 blocks


def test_bwd_plan_edges():
    assert fa.bwd_plan(0, 1024, 8, 8, H100_SMS) == 1
    assert fa.bwd_plan(1, 64, 8, 8, H100_SMS) == 1      # G = 1
    assert fa.bwd_plan(1, 64, 48, 1, H100_SMS) == 48    # never enough


# (G label, B, S, Hq, Hkv, D)
SPLIT_SHAPES = [("G4", 2, 40, 8, 2, 16), ("G12", 1, 40, 12, 1, 8)]


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=[s[0] for s in SPLIT_SHAPES])
def test_split_plain_version_matches_unsplit_and_reference(shape, n_split):
    """The fold of the split partials against the unsplit plain backward
    and the reference's ``jax.vjp`` of ``blockwise_attention``, given the
    reference's own out and lse; fp32 within 1e-5 (summation order)."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_bwd_split_ref)
    _, B, S, Hq, Hkv, D = shape
    q, k, v, g = _inputs(B, S, Hq, Hkv, D, seed=5 + n_split)
    kw = dict(causal=True)
    out, lse, dq, dk, dv = _reference(q, k, v, g, kw, jnp.float32)
    tq, tk, tv, tg, tout, tlse = (torch.tensor(a) for a in
                                  (q, k, v, g, out, lse))
    got = flash_attention_bwd_split_ref(tq, tk, tv, tout, tg, tlse,
                                        causal=True, n_split=n_split)
    plain = flash_attention_bwd_ref(tq, tk, tv, tout, tg, tlse, causal=True)
    for a, b, want in zip(got, plain, (dq, dk, dv)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        _close(a, b.numpy(), FP32_TOL)
        _close(a, want, FP32_TOL)


def test_split_plain_version_rounds_once():
    """bf16: the partials stay fp32 and the fold rounds once, so n_split
    1 gives the unsplit plain version bit for bit, and a split differs
    from it only by the fp32 summation order."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_bwd_split_ref)
    q, k, v, g = (torch.tensor(a).bfloat16()
                  for a in _inputs(1, 40, 12, 1, 8, seed=9))
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    plain = flash_attention_bwd_ref(q, k, v, out, g, lse, causal=True)
    one = flash_attention_bwd_split_ref(q, k, v, out, g, lse, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(one, plain))
    four = flash_attention_bwd_split_ref(q, k, v, out, g, lse, causal=True,
                                         n_split=4)
    assert torch.equal(four[0], plain[0])
    for a, b in zip(four[1:], plain[1:]):
        _close(a, b.float().numpy(), BF16_TOL)
    with pytest.raises(ValueError):
        flash_attention_bwd_split_ref(q, k, v, out, g, lse, n_split=5)
