"""Port parity for the MoE layer: ``repro_torch.models.moe`` against
``repro.models.moe`` on deepseek-v2-lite-reduced (shared experts) and
arctic-reduced (dense residual), with the JAX init's weights carried over.

fp32: routing (expert indices, capacity positions, drops) equal, outputs
and the aux loss within 1e-5 of the largest |value|, for both dispatches,
at the reduced configs' drop-free capacity, at a capacity factor of 0.25
that drops tokens, and at sequence lengths above ``group_size`` (one that
regroups, one that does not divide and keeps its batch rows as groups).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

TOL = 1e-5
ARCHS = ("deepseek-v2-lite-16b", "arctic-480b")
# (name, moe overrides, batch, sequence)
CASES = (("dropfree", {}, 2, 16),
         ("drops", dict(capacity_factor=0.25), 2, 16),
         ("regroup", dict(group_size=8), 2, 32),
         ("no_regroup", dict(group_size=8), 1, 20))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _cfgs(arch, **moe):
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **moe)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                              **moe)))


def _setup(arch, moe, B, S, seed=0):
    jcfg, tcfg = _cfgs(arch, **moe)
    jp = strip(JM.moe_init(jax.random.key(seed), jcfg))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, _to_torch(jp), x


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_routing_and_capacity_equal_reference(arch, case):
    _, moe, B, S = case
    jcfg, tcfg, jp, tp, x = _setup(arch, moe, B, S)
    g = jcfg.moe.group_size
    if S > g and S % g == 0:
        x = x.reshape(B * (S // g), g, -1)
    jg, ji, jprobs = JM._routing(jp, jcfg.moe, jnp.asarray(x))
    tg, ti, tprobs = TM._routing(tp, tcfg.moe, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert _rel(tg, jg) <= TOL and _rel(tprobs, jprobs) <= TOL
    C = JM.capacity(jcfg.moe, x.shape[1])
    assert TM.capacity(tcfg.moe, x.shape[1]) == C
    jpos, jkeep = JM._capacity_positions(ji, jg, jcfg.moe.num_experts, C)
    tpos, tkeep = TM._capacity_positions(ti, tcfg.moe.num_experts, C)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    # the reduced configs are drop-free; a capacity factor of 0.25 drops
    assert bool((~tkeep).any()) == ("capacity_factor" in moe)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_apply_matches_reference(arch, case, dispatch):
    _, moe, B, S = case
    jcfg, tcfg, jp, tp, x = _setup(arch, moe, B, S)
    jy, jaux = JM.moe_apply(jp, jcfg, jnp.asarray(x), dispatch_impl=dispatch)
    ty, taux = TM.moe_apply(tp, tcfg, torch.from_numpy(x),
                            dispatch_impl=dispatch)
    assert ty.shape == (B, S, jcfg.d_model) and ty.dtype == torch.float32
    assert _rel(ty, jy) <= TOL
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dispatches_agree_and_unknown_raises(case):
    _, moe, B, S = case
    _, tcfg, _, tp, x = _setup("deepseek-v2-lite-16b", moe, B, S, seed=1)
    xt = torch.from_numpy(x)
    ye, ae = TM.moe_apply(tp, tcfg, xt, dispatch_impl="einsum")
    yg, ag = TM.moe_apply(tp, tcfg, xt, dispatch_impl="gather")
    assert _rel(yg, ye) <= TOL and float(ae) == float(ag)
    with pytest.raises(ValueError):
        TM.moe_apply(tp, tcfg, xt, dispatch_impl="sparse")


def test_bf16_moe_within_tolerance():
    """bf16 activations and weights: the port's MoE within 3e-2 of the
    reference's largest |y| (both round the combine and the expert
    products to bf16, at other points)."""
    jcfg, tcfg, jp, tp, x = _setup("deepseek-v2-lite-16b", {}, 2, 16)
    jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tb = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()}
              if isinstance(v, dict) else v.to(torch.bfloat16))
          for k, v in tp.items()}
    jy, _ = JM.moe_apply(jb, jcfg, jnp.asarray(x, jnp.bfloat16))
    ty, _ = TM.moe_apply(tb, tcfg, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    assert _rel(ty.float(), np.asarray(jy, np.float32)) <= 3e-2


def test_one_hot_zeroes_out_of_range_like_jax():
    idx = torch.tensor([[0, 3, 4, -1]])
    got = TM._one_hot(idx, 4, torch.int32).numpy()
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx.numpy()), 4,
                                     dtype=jnp.int32))
    np.testing.assert_array_equal(got, want)


def test_init_shapes_follow_the_config():
    cfg = get_reduced("deepseek-v2-lite-16b")
    mo = cfg.moe
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg,
                    dtype=torch.float32, device="cpu")
    assert p["router"].shape == (cfg.d_model, mo.num_experts)
    assert p["experts"]["w_up"].shape == (mo.num_experts, cfg.d_model,
                                          mo.expert_d_ff)
    assert p["experts"]["w_down"].shape == (mo.num_experts, mo.expert_d_ff,
                                            cfg.d_model)
    assert p["shared"]["w_gate"].shape == (
        cfg.d_model, mo.num_shared_experts * mo.shared_d_ff)
    assert "dense" not in p
    arctic = get_reduced("arctic-480b")
    pa = TM.moe_init(torch.Generator().manual_seed(0), arctic,
                     dtype=torch.float32, device="cpu")
    assert pa["dense"]["w_up"].shape == (arctic.d_model,
                                         arctic.moe.dense_residual_d_ff)
    assert "shared" not in pa
