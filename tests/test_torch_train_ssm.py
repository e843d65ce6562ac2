"""The port's SSM and hybrid training against the reference's, on the CPU.

- The selective scan's training pair (``kernels/mamba_scan/ref.py``):
  ``selective_scan_fwd_ref``'s y and chunk-boundary states against the
  reference's ``_fused_fwd_pass``, and ``selective_scan_bwd_ref``'s
  (dx, ddt, dB, dC, dA, dD) against ``jax.vjp`` of its
  ``fused_selective_scan``, with ``serial`` False and True; fp32 within
  1e-5 of each tensor's largest magnitude (summation order only).  The
  autograd ``SelectiveScanFn`` on a CPU tensor gives the same gradients
  (A_log's through A = -exp(A_log)) and launches nothing.
- The plain flash forward with lse and backward under a sliding window,
  with the global-layer bypass, against the reference's ``_flash_fwd`` /
  ``_flash_bwd`` at hymba's group of 5 query heads per KV head; fp32
  within 1e-5.
- ``Model.loss`` and its gradients on falcon-mamba-reduced and
  hymba-reduced (window 8 at S 32, so that the window masks keys) against
  ``jax.value_and_grad`` of the reference's ``Model.loss`` with each
  ``ssm_impl`` (chunked, fused, fused_serial), the JAX init's fp32 weights
  carried over: loss within 1e-4 relative, each gradient leaf within 1e-3
  of its largest magnitude; bf16 activations: loss within 3e-2 relative.
- Two AdamW steps of ``make_train_step`` against the reference's (fp32):
  parameters within 1e-5, norm scales within 1e-6.
- The launcher trains both archs on the CPU, the last loss below the
  first.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.data import make_pipeline as jax_make_pipeline  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as ms  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    SCAN_CHUNK, selective_scan_bwd_ref, selective_scan_fwd_ref)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import make_optimizer, tree_leaves  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402

SCAN_TOL = 1e-5
ATTN_TOL = 1e-5
LOSS_FP32_TOL = 1e-4
GRAD_FP32_TOL = 1e-3
LOSS_BF16_TOL = 3e-2
PARAM_TOL = 1e-5
NORM_TOL = 1e-6
SSM_ARCHS = ("falcon-mamba-7b", "hymba-1.5b")
SSM_IMPLS = ("chunked", "fused", "fused_serial")


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# the scan's training pair
# ---------------------------------------------------------------------------

def _scan_inputs(B, S_len, D, N, seed=0):
    """x, dt (softplus'd), b, c, A_log (log 1..N per channel), d and an
    output gradient, numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S_len, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S_len, D)) - 1.0)).astype(
        np.float32)
    b = rng.normal(size=(B, S_len, N)).astype(np.float32)
    c = rng.normal(size=(B, S_len, N)).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32), (D, 1)))
    d = rng.normal(size=(D,)).astype(np.float32)
    gy = rng.normal(size=(B, S_len, D)).astype(np.float32)
    return x, dt, b, c, a_log, d, gy


def _jax_scan_vjp(ins, chunk, serial):
    x, dt, b, c, a_log, d, gy = ins
    A = -np.exp(a_log)
    args = tuple(jnp.asarray(t) for t in (x, dt, b, c, A, d))
    y, vjp = jax.vjp(lambda *a: JS.fused_selective_scan(*a, chunk, serial),
                     *args)
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(gy))]


@pytest.mark.parametrize("serial", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 6, 4, 8), (1, 64, 5, 16, 16),
                                   (2, 48, 3, 8, 16)],
                         ids=["N4", "N16", "N8"])
def test_plain_scan_pair_matches_reference(shape, serial):
    """The plain forward's y and boundary states, and the plain backward's
    six gradients, against the reference's fused scan at the same chunk."""
    B, S_len, D, N, chunk = shape
    ins = _scan_inputs(B, S_len, D, N, seed=S_len + N)
    y_want, grads_want = _jax_scan_vjp(ins, chunk, serial)
    fwd_pass = JS._serial_fwd_pass if serial else JS._fused_fwd_pass
    _, bounds_want = fwd_pass(*(jnp.asarray(t) for t in (
        ins[0], ins[1], ins[2], ins[3], -np.exp(ins[4]), ins[5])), chunk)
    t = [torch.tensor(a) for a in ins]
    y, bounds = selective_scan_fwd_ref(*t[:6], chunk=chunk)
    _close(y, y_want, SCAN_TOL, "y")
    _close(bounds, np.asarray(bounds_want), SCAN_TOL, "bounds")
    got = selective_scan_bwd_ref(*t[:6], bounds, t[6], chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "db", "dc", "dA", "dD"), got,
                          grads_want):
        _close(g, w, SCAN_TOL, name)


def test_plain_scan_takes_any_length():
    """S no multiple of the chunk (the last chunk short): the gradients
    equal the reference's at a chunk that divides S, since the chunk sets
    only what is recomputed."""
    ins = _scan_inputs(2, 44, 6, 16, seed=5)
    _, grads_want = _jax_scan_vjp(ins, 4, False)
    t = [torch.tensor(a) for a in ins]
    y, bounds = selective_scan_fwd_ref(*t[:6])
    assert bounds.shape == (-(-44 // SCAN_CHUNK), 2, 6, 16)
    got = selective_scan_bwd_ref(*t[:6], bounds, t[6])
    for name, g, w in zip(("dx", "ddt", "db", "dc", "dA", "dD"), got,
                          grads_want):
        _close(g, w, SCAN_TOL, name)


def test_scan_function_on_cpu_matches_reference():
    """``SelectiveScanFn`` (through ``ssm.fused_selective_scan``) on CPU
    tensors: y and the gradients of x, dt, b and c (strided views of one
    tensor, as x_proj's output gives them), A_log and d against the
    reference's VJP; no kernel launches."""
    ins = _scan_inputs(2, 40, 6, 8, seed=9)
    y_want, grads_want = _jax_scan_vjp(ins, 8, False)
    x, dt, b, c, a_log, d, gy = (torch.tensor(a) for a in ins)
    dbc = torch.cat([b, c], dim=-1).requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a_log, d)]
    before = (ms.scan_launches, ms.scan_train_launches,
              ms.scan_bwd_launches)
    y = S.fused_selective_scan(leaves[0], leaves[1], dbc[..., :8],
                               dbc[..., 8:], leaves[2], leaves[3])
    y.backward(gy)
    assert (ms.scan_launches, ms.scan_train_launches,
            ms.scan_bwd_launches) == before
    _close(y.detach(), y_want, SCAN_TOL, "y")
    dx, ddt, db, dc, dA, dd = grads_want
    for name, g, w in (("dx", leaves[0].grad, dx), ("ddt", leaves[1].grad,
                       ddt), ("db", dbc.grad[..., :8], db),
                       ("dc", dbc.grad[..., 8:], dc), ("dd", leaves[3].grad,
                                                      dd)):
        _close(g, w, SCAN_TOL, name)
    _close(leaves[2].grad, dA * -np.exp(ins[4]), SCAN_TOL, "dA_log")


def test_cpu_scan_wrappers_take_the_plain_pair():
    """``mamba_scan(..., bounds=True)`` and ``mamba_scan_bwd`` on CPU
    tensors return the plain pair's values, and the serving scan's y and
    last state stay ``mamba_scan_ref``'s."""
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    x, dt, b, c, a_log, d, gy = (torch.tensor(a) for a in
                                 _scan_inputs(1, 70, 4, 4, seed=2))
    y, h, bounds = ms.mamba_scan(x, dt, b, c, a_log, d, bounds=True)
    y_s, h_s = mamba_scan_ref(x, dt, b, c, a_log, d)
    assert torch.equal(y, y_s) and torch.equal(h, h_s)
    assert torch.equal(bounds, selective_scan_fwd_ref(x, dt, b, c, a_log,
                                                      d)[1])
    got = ms.mamba_scan_bwd(x, dt, b, c, a_log, d, bounds, gy)
    want = selective_scan_bwd_ref(x, dt, b, c, a_log, d, bounds, gy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mamba_fwd_without_grad_is_the_prefill():
    """The embedding stacks' Mamba block: ``mamba_fwd`` without autograd
    equals ``mamba_prefill``'s output bitwise, and under autograd its
    forward agrees to fp32 rounding."""
    cfg = TC.get_reduced("falcon-mamba-7b")
    gen = torch.Generator().manual_seed(0)
    p = S.mamba_init(gen, cfg, dtype=torch.float32, device="cpu")
    x = torch.randn((2, 37, cfg.d_model), generator=gen)
    with torch.no_grad():
        got = S.mamba_fwd(p, cfg, x)
        cache = S.mamba_cache_init(cfg, 2, torch.float32, "cpu")
        want = S.mamba_prefill(p, cfg, x, cache)[0]
    assert torch.equal(got, want)
    graded = S.mamba_fwd({k: v.requires_grad_(True) for k, v in p.items()},
                         cfg, x)
    _close(graded.detach(), want, SCAN_TOL, "graded forward")


# ---------------------------------------------------------------------------
# the windowed flash forward and backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,is_global", [(8, False), (8, True),
                                              (8, None), (0, None),
                                              (20, False)])
def test_windowed_flash_plain_versions_match_reference(window, is_global):
    """``flash_attention_lse_ref`` and ``flash_attention_bwd_ref`` (the
    kernels' plain versions) under a sliding window against the
    reference's ``_flash_fwd`` / ``_flash_bwd``: 10 query heads on 2 KV
    heads (hymba's group of 5), S 40, causal."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    rng = np.random.default_rng(window + 3 * bool(is_global))
    B, S_len, Hq, Hkv, D = 2, 40, 10, 2, 16
    q, dout = (rng.normal(size=(B, S_len, Hq, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(B, S_len, Hkv, D)).astype(np.float32)
            for _ in range(2))
    glob = None if is_global is None else jnp.asarray(is_global)
    out_w, res = JL._flash_fwd(True, window, S_len, 0.0, jnp.asarray(q),
                               jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(0), jnp.asarray(S_len), glob)
    grads_w = JL._flash_bwd(True, window, S_len, 0.0, res,
                            jnp.asarray(dout))[:3]
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, dout))
    out, lse = flash_attention_lse_ref(tq, tk, tv, causal=True,
                                       window=window, is_global=is_global)
    _close(out, np.asarray(out_w), ATTN_TOL, "out")
    _close(lse, np.asarray(res[4]), ATTN_TOL, "lse")
    got = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, causal=True,
                                  window=window, is_global=is_global)
    for name, g, w in zip(("dq", "dk", "dv"), got, grads_w):
        _close(g, np.asarray(w), ATTN_TOL, name)
    # the wrappers on CPU tensors take them, under the same mask
    before = (fa.lse_window_launches, fa.bwd_window_launches)
    out2, lse2 = fa.flash_attention_lse(tq, tk, tv, window=window,
                                        is_global=is_global)
    got2 = fa.flash_attention_bwd(tq, tk, tv, out2, tdo, lse2,
                                  window=window, is_global=is_global)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    assert all(torch.equal(a, b) for a, b in zip(got2, got))
    assert (fa.lse_window_launches, fa.bwd_window_launches) == before


# ---------------------------------------------------------------------------
# Model.loss and the train step
# ---------------------------------------------------------------------------

def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, strip(jm.init(jax.random.key(7))))
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jp, tcfg, "cpu", dtype=torch.float32)
    return jm, jax.tree.map(jnp.asarray, jp), tm, tp


def _batch(cfg, B=2, S_len=32, step=0):
    b = jax_make_pipeline(cfg, S_len, B, seed=3).batch(step)
    b["labels"][0, -3:] = -1                   # masked positions
    return b


def _pairs(tp, jtree):
    """(name, port tensor, reference array) for every port leaf; a decoder
    layer's leaf against its slice of the reference's stacked leaf."""
    out = []

    def walk(t, j, path, layer=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, j[k], path + (k,), layer)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, j, path + (i,), i)
        else:
            arr = np.asarray(j, np.float32)
            out.append((".".join(map(str, path)), t,
                        arr if layer is None else arr[layer]))

    for key, t in tp.items():
        j = jtree[key]
        if key == "decoder":
            walk(t["layers"], j["scanned"], ("decoder", "layers"))
        else:
            walk(t, j, (key,))
    return out


def _port_grads(tm, tp, batch):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = tm.loss(tp, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    loss.backward()
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics


def _rel(got, want):
    return abs(got - want) / abs(want)


def test_hymba_reduced_window_masks_at_the_test_length():
    """The checks below run hymba-reduced at S 32 > its window of 8, with
    a sliding layer among its global one, so the window masks keys."""
    cfg = TC.get_reduced("hymba-1.5b")
    assert cfg.attn_type == "sliding" and 0 < cfg.window_size < 32
    assert set(range(cfg.num_layers)) - set(cfg.global_attn_layers)


@pytest.mark.parametrize("impl", SSM_IMPLS)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_and_grads_match_reference_fp32(arch, impl):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, ssm_impl=impl), has_aux=True))(jp)
    loss, metrics = _port_grads(tm, tp, batch)
    assert _rel(loss.item(), float(jloss)) <= LOSS_FP32_TOL
    assert _rel(metrics["xent"].item(), float(jmet["xent"])) <= LOSS_FP32_TOL
    assert metrics["aux"].item() == 0.0
    seen = 0
    for name, t, want in _pairs(tp, jgrads):
        got = t.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-8)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_FP32_TOL * scale, (name, err, scale)
        seen += 1
    assert seen == len(tree_leaves(tp))
    a_log = tp["decoder"]["layers"][0]["ssm"]["A_log"]
    assert float(a_log.grad.abs().max()) > 0.0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_matches_reference_bf16(arch):
    jm, jp, tm, tp = _pair(arch, dtype="bfloat16")
    batch = _batch(tm.cfg)
    jloss, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    loss, _ = _port_grads(tm, tp, batch)
    assert _rel(loss.item(), float(jloss)) <= LOSS_BF16_TOL
    assert all(t.grad is not None and t.grad.isfinite().all()
               for t in tree_leaves(tp))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_train_steps_match_reference(arch):
    """Two AdamW steps (lr 1e-3, warmup 1, fp32) of ``make_train_step``
    against the reference's."""
    jm, jp, tm, tp = _pair(arch)
    assert tm.cfg.optimizer == "adamw"
    kw = dict(steps=10, lr=1e-3, warmup=1)
    jstep = jax.jit(jax_make_train_step(
        jm, jax_make_optimizer(jm.cfg.optimizer), JaxTrainConfig(**kw)))
    opt = make_optimizer(tm.cfg.optimizer)
    tstep = make_train_step(tm, opt, TrainConfig(**kw))
    jstate = jax_make_optimizer(jm.cfg.optimizer).init(jp)
    tstate = opt.init(tp)
    for s in range(2):
        batch = jax_make_pipeline(tm.cfg, 16, 4, seed=s).batch(s)
        jp, jstate, jm_ = jstep(jp, jstate, jnp.asarray(s),
                                {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, tm_ = tstep(tp, tstate, s,
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
        assert _rel(float(tm_["loss"]), float(jm_["loss"])) <= LOSS_FP32_TOL
        assert _rel(float(tm_["grad_norm"]), float(jm_["grad_norm"])) <= \
            1e-3
    for name, t, want in _pairs(tp, jp):
        tol = NORM_TOL if name.endswith(("scale", "bias")) else PARAM_TOL
        err = float(np.abs(t.numpy() - want).max())
        assert err <= tol, (name, err)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_launcher_trains_ssm_on_cpu(tmp_path, arch):
    seen = []
    rc = launch_train.main(["--arch", arch, "--reduced", "--steps", "6",
                            "--seq-len", "32", "--global-batch", "4",
                            "--lr", "3e-3", "--ckpt-dir",
                            str(tmp_path / "ck"), "--device", "cpu"],
                           on_step=lambda s, m: seen.append(m))
    assert rc == 0
    assert [m["step"] for m in seen] == list(range(6))
    assert all(np.isfinite(m["loss"]) for m in seen)
    assert seen[-1]["loss"] < seen[0]["loss"]
