"""Port parity for the SSM slice's block and kernels: the plain versions of
the Mamba step and selective-scan kernels against the JAX package's Pallas
kernels (interpret mode) and oracles, ``mamba_prefill`` against the JAX
one, prefill-then-step against stepping token by token, the wrappers' CPU
dispatch, the init, the bridge and the SSM cache layout.  Inputs come from
numpy with a seed.

Tolerances (fp32 throughout): the step to 3e-5, the JAX suite's own bound
for its fused step against its oracle; the scan's y and last state to 1e-5
(summation order only: the reference sums inside a chunk with an
associative scan, the port in time order); a block's output, which adds a
d_in-long out_proj sum on top, to 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.kernels.mamba_scan import kernel as jax_kernel  # noqa: E402
from repro.kernels.mamba_scan import mamba_step_fused  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_scan_ref  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_step_ref as jax_step_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_ref,  # noqa: E402
                                                mamba_step_ref)
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

RNG = np.random.default_rng(11)
STEP_TOL = 3e-5
SCAN_TOL = 1e-5
BLOCK_TOL = 1e-4
ORDER = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
         "A_log", "D", "out_proj")


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_get_reduced("falcon-mamba-7b"),
                                dtype=dtype),
            dataclasses.replace(get_reduced("falcon-mamba-7b"), dtype=dtype))


def _block(seed=3):
    """One Mamba block's weights from the JAX init, as numpy arrays."""
    jcfg, _ = _cfgs()
    return {k: np.asarray(getattr(v, "value", v), np.float32)
            for k, v in JS.mamba_init(jax.random.PRNGKey(seed), jcfg).items()}


def _state(cfg, B):
    d_in, _, n, w = TS.dims(cfg)
    return (RNG.normal(size=(B, 1, cfg.d_model)).astype(np.float32),
            RNG.normal(size=(B, w - 1, d_in)).astype(np.float32),
            RNG.normal(size=(B, d_in, n)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("live", [None, [True, False, True]])
def test_step_plain_matches_pallas_interpret_and_oracle(live):
    _, cfg = _cfgs()
    p = _block()
    x1, conv, h = _state(cfg, 3)
    jargs = [jnp.asarray(a) for a in (x1, conv, h)] + [
        jnp.asarray(p[k]) for k in ORDER]
    jlive = None if live is None else jnp.asarray(live)
    want_k = mamba_step_fused(*jargs, live=jlive, impl="interpret")
    want_r = jax_step_ref(*jargs, live=jlive)
    targs = [torch.tensor(a) for a in (x1, conv, h)] + [
        torch.tensor(p[k]) for k in ORDER]
    tlive = None if live is None else torch.tensor(live)
    got = mamba_step_ref(*targs, live=tlive)
    for want in (want_k, want_r):
        for g, w in zip(got, want):
            _close(g.numpy(), w, STEP_TOL)
    if live is not None:
        out, new_conv, new_h = got
        assert (out[1] == 0).all()
        assert torch.equal(new_conv[1], targs[1][1])
        assert torch.equal(new_h[1], targs[2][1])


def test_step_wrapper_takes_plain_on_cpu_and_updates_in_place():
    _, cfg = _cfgs()
    p = {k: torch.tensor(v) for k, v in _block(4).items()}
    x1, conv, h = (torch.tensor(a) for a in _state(cfg, 4))
    live = torch.tensor([True, True, False, True])
    want = mamba_step_ref(x1, conv, h, *(p[k] for k in ORDER), live=live)
    conv0, h0 = conv.clone(), h.clone()
    before = ops.step_launches
    out = ops.mamba_step(x1, conv, h, *(p[k] for k in ORDER), live=live)
    assert ops.step_launches == before
    assert torch.equal(out, want[0])
    assert torch.equal(conv, want[1]) and torch.equal(h, want[2])
    assert torch.equal(conv[2], conv0[2]) and torch.equal(h[2], h0[2])
    assert not torch.equal(h[0], h0[0])


# ---------------------------------------------------------------------------
# the prefill selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(B, S, D, N):
    return (RNG.normal(size=(B, S, D)).astype(np.float32),
            RNG.uniform(0.001, 0.1, size=(B, S, D)).astype(np.float32),
            RNG.normal(size=(B, S, N)).astype(np.float32),
            RNG.normal(size=(B, S, N)).astype(np.float32),
            np.log(RNG.uniform(0.5, 4.0, size=(D, N))).astype(np.float32),
            RNG.normal(size=(D,)).astype(np.float32))


def test_scan_plain_matches_pallas_interpret_oracle_and_chunked_scan():
    """S = 40 is no multiple of the chunk of 16: the last chunk is short."""
    B, S, D, N = 2, 40, 32, 4
    x, dt, b, c, a_log, d = _scan_inputs(B, S, D, N)
    jin = [jnp.asarray(a) for a in (x, dt, b, c, a_log, d)]
    want_k = jax_kernel.mamba_scan(*jin, bd=16, bs=8, interpret=True)
    want_r = jax_scan_ref(*jin)
    a = -np.exp(a_log)
    delta_a = jnp.exp(jnp.asarray(dt)[..., None] * a)
    delta_bx = jnp.asarray((dt * x)[..., None] * b[:, :, None, :])
    _, want_h = JS.selective_scan(delta_a, delta_bx,
                                  jnp.zeros((B, D, N), jnp.float32),
                                  chunk=16)
    y, h_last = mamba_scan_ref(*(torch.tensor(v) for v in
                                 (x, dt, b, c, a_log, d)), chunk=16)
    assert y.dtype == h_last.dtype == torch.float32
    _close(y.numpy(), want_k, SCAN_TOL)
    _close(y.numpy(), want_r, SCAN_TOL)
    _close(h_last.numpy(), want_h, SCAN_TOL)
    # the default chunk of 128 exceeds S: the same function
    y2, h2 = mamba_scan_ref(*(torch.tensor(v) for v in
                              (x, dt, b, c, a_log, d)))
    _close(y2.numpy(), y.numpy(), SCAN_TOL)
    _close(h2.numpy(), h_last.numpy(), SCAN_TOL)


def test_scan_wrapper_takes_plain_on_cpu():
    ins = [torch.tensor(v) for v in _scan_inputs(1, 7, 8, 4)]
    before = ops.scan_launches
    y, h = ops.mamba_scan(*ins)
    want_y, want_h = mamba_scan_ref(*ins)
    assert ops.scan_launches == before
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


# ---------------------------------------------------------------------------
# the block: prefill against the reference, prefill-then-step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("S", [11, 3])
def test_prefill_matches_reference(use_kernels, S):
    jcfg, cfg = _cfgs()
    p = _block()
    B = 2
    x = RNG.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jcache = strip(JS.mamba_cache_init(jcfg, B, np.float32))
    want_out, want_cache = JS.mamba_prefill(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        jcache)
    cache = TS.mamba_cache_init(cfg, B, torch.float32, "cpu")
    out, got = TS.mamba_prefill({k: torch.tensor(v) for k, v in p.items()},
                                cfg, torch.tensor(x), cache,
                                use_kernels=use_kernels)
    assert got is cache
    _close(out.numpy(), want_out, BLOCK_TOL)
    _close(got["conv"].numpy(), want_cache["conv"], SCAN_TOL)
    _close(got["h"].numpy(), want_cache["h"], SCAN_TOL)


@pytest.mark.parametrize("S", [11, 2])
def test_prefill_then_step_equals_stepwise(S):
    """The contract of the reference's
    ``test_mamba_prefill_state_matches_stepwise``, carried on: prefill the
    first S tokens, then step the rest; outputs and state equal stepping
    from a zero state.  S = 2
    is shorter than the conv window: the port zero-fills the window's
    head, as the causal conv pads."""
    _, cfg = _cfgs()
    p = {k: torch.tensor(v) for k, v in _block(5).items()}
    B, total = 2, S + 4
    x = torch.tensor(RNG.normal(size=(B, total, cfg.d_model)), dtype=torch.float32)
    pre = TS.mamba_cache_init(cfg, B, torch.float32, "cpu")
    out_p, _ = TS.mamba_prefill(p, cfg, x[:, :S], pre)
    after_prefill = {k: v.clone() for k, v in pre.items()}
    outs_p = [out_p]
    for t in range(S, total):
        y, _ = TS.mamba_step(p, cfg, x[:, t:t + 1], pre, use_kernels=True)
        outs_p.append(y)
    step = TS.mamba_cache_init(cfg, B, torch.float32, "cpu")
    outs_s = []
    for t in range(total):
        y, _ = TS.mamba_step(p, cfg, x[:, t:t + 1], step)
        outs_s.append(y)
        if t == S - 1:
            for k in ("conv", "h"):
                _close(after_prefill[k].numpy(), step[k].numpy(), SCAN_TOL)
    _close(torch.cat(outs_p, 1).numpy(), torch.cat(outs_s, 1).numpy(),
           BLOCK_TOL)
    _close(pre["h"].numpy(), step["h"].numpy(), SCAN_TOL)
    _close(pre["conv"].numpy(), step["conv"].numpy(), SCAN_TOL)


# ---------------------------------------------------------------------------
# init, bridge, cache layout
# ---------------------------------------------------------------------------

def test_mamba_init_follows_the_reference_init():
    cfg = get_reduced("falcon-mamba-7b")
    d_in, dt_rank, n, w = TS.dims(cfg)
    assert (d_in, dt_rank, n, w) == (128, 4, 4, 4)
    assert TS.state_elems(cfg) == (w - 1) * d_in + d_in * n
    p = TS.mamba_init(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.bfloat16, device="cpu")
    again = TS.mamba_init(torch.Generator().manual_seed(0), cfg,
                          dtype=torch.bfloat16, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert p["in_proj"].shape == (cfg.d_model, 2 * d_in)
    assert p["x_proj"].shape == (d_in, dt_rank + 2 * n)
    for k in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        assert p[k].dtype == torch.bfloat16
    for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D"):
        assert p[k].dtype == torch.float32
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert 1e-3 * 0.999 <= dt.min() and dt.max() <= 0.1 * 1.001
    assert torch.allclose(p["A_log"], torch.log(torch.arange(1.0, n + 1)).expand(d_in, n))
    assert (p["D"] == 1).all() and (p["conv_b"] == 0).all()
    assert 0.3 < float(p["conv_w"].std()) < 0.7        # 1 / sqrt(4)


def test_bridge_keeps_ssm_parameters_fp32_and_cache_layout():
    jcfg, cfg = _cfgs("bfloat16")
    jm = jax_build_model(jcfg)
    jp = strip(jm.init(jax.random.key(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    layer = tp["decoder"]["layers"][1]
    assert set(layer) == {"ln1", "ssm"}
    for k in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        assert layer["ssm"][k].dtype == torch.bfloat16
    for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D"):
        assert layer["ssm"][k].dtype == torch.float32
        np.testing.assert_array_equal(
            layer["ssm"][k].numpy(),
            np.asarray(jp["decoder"]["scanned"]["ssm"][k][1]))
    tm = Model(cfg, "cpu")
    cache = tm.init_cache(3, 8)
    d_in, _, n, w = TS.dims(cfg)
    ssm = cache["scanned"]["ssm"]
    assert ssm["conv"].shape == (cfg.num_layers, 3, w - 1, d_in)
    assert ssm["conv"].dtype == torch.bfloat16
    assert ssm["h"].shape == (cfg.num_layers, 3, d_in, n)
    assert ssm["h"].dtype == torch.float32
    taxes = tm.cache_slot_axes(cache)
    jaxes = jm.cache_slot_axes(strip(jm.init_cache(3, 8)))
    assert jax.tree.leaves(jaxes) == jax.tree.leaves(taxes)
    assert taxes == {"prologue": [], "scanned": {"ssm": {"conv": 1, "h": 1}},
                     "pos": 0}
