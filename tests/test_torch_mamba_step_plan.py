"""The bf16 Mamba step's weight products as the host plans them: ``plan()``
cuts each of the four products into (column strip, K span) work items
from host ints alone; the items cover every (column, K) of the product
exactly once, every SM streams the same number of them (within one), and
K is split only where the strips alone cannot fill the card.  Checked at
falcon-mamba-7b widths on 132 SMs and at the reduced widths.  Then the
kernel's fixed summation order (``skinny_product_spec``) against the
product in fp64, and the plain step ``mamba_step_ref`` against the JAX
oracle at the slot counts the GPU tests take.

Tolerances: the spec sums bf16 products (exact in fp32) in fp32 in chains
of at most K / 16 + 16 additions, so it is held to 2**-24 x (K / 16 + 16)
x the sum of |x||w| of each output, the bound of that chain; the plain
step to 3e-5 in fp32, as in ``test_torch_ssm.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.kernels.mamba_scan.ref import mamba_step_ref as jax_step_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    mamba_step_ref, skinny_product_spec)
from repro_torch.models import ssm as TS  # noqa: E402

SMS = 132
STEP_TOL = 3e-5
ORDER = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
         "A_log", "D", "out_proj")
PRODUCTS = ("in_proj", "x_proj", "dt_proj", "out_proj")


def _products(cfg):
    """(K, N) of in_proj, x_proj, dt_proj and out_proj."""
    d_in, R, N, _ = TS.dims(cfg)
    return dict(zip(PRODUCTS, ((cfg.d_model, 2 * d_in), (d_in, R + 2 * N),
                               (R, d_in), (d_in, cfg.d_model))))


def _items_per_sm(p, sms):
    """Work items each SM streams when block ``b`` runs on SM ``b % sms``
    and walks items ``b, b + grid, ...``, as the kernel's loop does."""
    counts = [0] * sms
    for i in range(p.items):
        counts[(i % p.grid) % sms] += 1
    return counts


def _plan_items(p, K, N):
    """The (column begin, column end, K begin, K end) of every work item,
    as the kernel derives them from its item index (64-column strips)."""
    for i in range(p.items):
        strip, split = divmod(i, p.splits)
        yield (strip * 64, min(N, (strip + 1) * 64), split * p.span,
               min(K, (split + 1) * p.span))


WIDTHS = {"falcon": _products(get_config("falcon-mamba-7b")),
          "reduced": _products(get_reduced("falcon-mamba-7b"))}
CASES = [(w, p, B) for w in WIDTHS for p in PRODUCTS for B in (1, 8, 11, 16)]


@pytest.mark.parametrize("widths,product,B", CASES)
def test_plan_covers_every_column_and_k_once(widths, product, B):
    K, N = WIDTHS[widths][product]
    p = ops.plan(B, K, N, SMS)
    spans = {}
    for n0, n1, k0, k1 in _plan_items(p, K, N):
        assert 0 <= n0 < n1 <= N and 0 <= k0 < k1 <= K
        spans.setdefault((n0, n1), []).append((k0, k1))
    strips = sorted(spans)
    assert strips[0][0] == 0 and strips[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(strips, strips[1:]))
    for ks in spans.values():
        ks.sort()
        assert ks[0][0] == 0 and ks[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))
    assert p.items == sum(len(ks) for ks in spans.values())


@pytest.mark.parametrize("widths,product,B", CASES)
def test_plan_gives_every_sm_the_same_item_count(widths, product, B):
    K, N = WIDTHS[widths][product]
    p = ops.plan(B, K, N, SMS)
    counts = _items_per_sm(p, SMS)
    assert sum(counts) == p.items
    assert max(counts) - min(counts) <= 1
    # one resident wave, or a whole number of blocks on every SM
    cap = ops.resident(min(B, 32)) * SMS
    assert p.grid == min(p.items, cap)
    assert p.grid <= cap and (p.grid == p.items or p.grid % SMS == 0)


@pytest.mark.parametrize("widths,product,B", CASES)
def test_plan_splits_k_only_where_strips_cannot_fill_the_card(
        widths, product, B):
    K, N = WIDTHS[widths][product]
    p = ops.plan(B, K, N, SMS)
    strips = -(-N // 64)
    assert p.route == 1 and p.span % 128 == 0
    assert p.splits == -(-K // p.span)          # equal spans, none empty
    if p.splits > 1:
        assert strips < SMS
        assert p.span >= 2 * 128                 # at least two ring stages
        assert p.items >= SMS                    # the split fills the card


def test_plan_at_falcon_widths():
    """in_proj's 256 strips fill the card unsplit and write bf16 directly;
    out_proj and x_proj split K into one resident wave."""
    prods = WIDTHS["falcon"]
    plans = {k: ops.plan(8, *prods[k], SMS) for k in PRODUCTS}
    assert plans["in_proj"].splits == 1 and plans["in_proj"].items == 256
    assert plans["out_proj"].splits > 1 and plans["x_proj"].splits > 1
    for p in plans.values():
        assert p.items <= ops.resident(8) * SMS and p.grid == p.items


def test_plan_is_computed_from_host_ints_alone(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plan() touched a tensor or the device")
    for name in ("empty", "zeros", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    ops.plan.cache_clear()
    p = ops.plan(8, 8192, 4096, SMS)
    assert all(type(v) is int for v in p)
    assert ops.plan(8, 8192, 4096, SMS) == p


@pytest.mark.parametrize("B,K,N", [(8, 8192, 288), (11, 2048, 200),
                                   (16, 1024, 64), (3, 256, 96)])
def test_split_sum_spec_equals_the_product_in_fp32(B, K, N):
    rng = np.random.default_rng(B * 7 + K)
    x = torch.tensor(rng.normal(size=(B, K)), dtype=torch.bfloat16)
    w = torch.tensor(rng.normal(size=(K, N)) / np.sqrt(K),
                     dtype=torch.bfloat16)
    p = ops.plan(B, K, N, SMS)
    got = skinny_product_spec(x, w, p.splits, p.span).double()
    want = x.double() @ w.double()
    chain = K / 16 + 16
    bound = 2.0 ** -24 * chain * (x.double().abs() @ w.double().abs())
    assert ((got - want).abs() <= bound).all()
    # the unsplit order is held to the same bound
    one = skinny_product_spec(x, w, 1, K).double()
    assert ((one - want).abs() <= bound).all()


@pytest.mark.parametrize("B", [1, 8, 11, 16])
def test_mamba_step_ref_matches_the_jax_oracle(B):
    """The plain step, which the kernel is held to on the card, is the
    reference's at every slot count the GPU tests take; row 0 is dead."""
    jcfg = dataclasses.replace(jax_get_reduced("falcon-mamba-7b"),
                               dtype="float32")
    cfg = dataclasses.replace(get_reduced("falcon-mamba-7b"),
                              dtype="float32")
    p = {k: np.asarray(getattr(v, "value", v), np.float32) for k, v in
         JS.mamba_init(jax.random.PRNGKey(B), jcfg).items()}
    d_in, _, n, w = TS.dims(cfg)
    rng = np.random.default_rng(B)
    state = (rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32),
             rng.normal(size=(B, w - 1, d_in)).astype(np.float32),
             rng.normal(size=(B, d_in, n)).astype(np.float32))
    live = np.ones(B, bool)
    live[0] = False
    want = jax_step_ref(*(jnp.asarray(a) for a in state),
                        *(jnp.asarray(p[k]) for k in ORDER),
                        live=jnp.asarray(live))
    got = mamba_step_ref(*(torch.tensor(a) for a in state),
                         *(torch.tensor(p[k]) for k in ORDER),
                         live=torch.tensor(live))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    assert (got[0][0] == 0).all()
    assert torch.equal(got[2][0], torch.tensor(state[2][0]))
