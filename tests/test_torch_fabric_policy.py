"""The port's fabric arithmetic against the reference's, function by
function, with no device: delta planning (``plan_recomposition``,
``recomposition_delta``), the split enumeration (``_compositions``,
``_candidate_splits``), the serving DSE's Stage 1 (``best``, ``cost_of``,
``design_key``), ``AnalyticalPolicy.decide`` over a grid of observations,
and ``arrival_schedule``.

The reference prices on its ``TPU_V5E`` profile, where one chip is one
CU.  The port's policy takes ONE CU's profile, so here it gets a profile
holding those numbers, written below (and checked against the reference's
record field by field): the same prices must give the same decisions,
reasons, runner-ups and predicted makespans, costs within a relative
1e-12.  The reference's own policy and plan tests
(``tests/test_fabric.py``) run again as cases against the port.
"""
import dataclasses
import itertools
import math

import pytest

pytest.importorskip("torch")

from repro.common.platform import TPU_V5E as REF_TPU  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.core import composer as ref_composer  # noqa: E402
from repro.core.dse import DesignPoint as RefPoint  # noqa: E402
from repro.serve import dse as ref_dse  # noqa: E402
from repro.serve import fabric as ref_fabric  # noqa: E402
from repro.serve import traffic as ref_traffic  # noqa: E402
from repro_torch.common.platform import (H100_SXM, PlatformProfile,  # noqa: E402
                                         per_cu)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import composer  # noqa: E402
from repro_torch.core.composer import (RecompositionDelta,  # noqa: E402
                                       plan_recomposition,
                                       recomposition_delta)
from repro_torch.core.dse import DesignPoint  # noqa: E402
from repro_torch.serve import dse, traffic  # noqa: E402
from repro_torch.serve import fabric  # noqa: E402
from repro_torch.serve.fabric import (AnalyticalPolicy,  # noqa: E402
                                      TenantObservation, _candidate_splits,
                                      _compositions)

# the reference's TPU_V5E numbers, as one CU of the port's policy
TPU_NUMBERS = PlatformProfile(
    name="tpu_v5e", peak_flops=197e12, atom_shape=(8, 128, 128),
    atom_cycles=8.0, compute_clock_hz=0.94e9, num_compute_units=4,
    hbm_bytes=16 << 30, hbm_bw=819e9, onchip_bytes=128 << 20,
    onchip_bw=22e12, ici_bw=50e9, ici_links=4, instr_bytes=32,
    reconfig_cycles=16.0, bitstream_reload_s=10.0)

REL = 1e-12
ARCHS = ("minitron-4b", "falcon-mamba-7b")


def test_tpu_numbers_are_the_reference_profile():
    assert dataclasses.asdict(TPU_NUMBERS) == dataclasses.asdict(REF_TPU)


def test_h100_profile_and_cu_share():
    """The card's bf16 rate from its clock and atom rate is the data sheet's 989
    TFLOP/s; a CU of 8 holds an eighth of everything."""
    p = H100_SXM
    rate = p.num_compute_units * p.atom_flops * p.compute_clock_hz \
        / p.atom_cycles
    assert abs(rate - 989e12) / 989e12 < 1e-3
    assert (p.hbm_bw, p.hbm_bytes) == (3.35e12, 80 * 10**9)
    q = per_cu(p, 8)
    assert q.hbm_bw == p.hbm_bw / 8 and q.hbm_bytes == p.hbm_bytes // 8
    assert q.num_compute_units == 16.5 and q.peak_flops == p.peak_flops / 8
    assert AnalyticalPolicy().platform == q


def _close(a, b):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _pt(p):
    return (p.cus, p.tp, p.slots,
            tuple(p.buckets) if p.buckets is not None else None, p.dp)


def _same_points(ref, got):
    assert (ref is None) == (got is None)
    if ref is None:
        return
    assert set(ref) == set(got)
    for t in ref:
        assert _pt(ref[t]) == _pt(got[t]), t
        assert _close(ref[t].cost, got[t].cost), (t, ref[t].cost,
                                                  got[t].cost)


# ---------------------------------------------------------------------------
# delta planning and split enumeration
# ---------------------------------------------------------------------------

def _plans():
    """(current, target sizes) pairs over 8 CUs: grow, shrink, park, admit,
    three tenants, gaps in the ids."""
    currents = [
        {},
        {"a": (0, 1, 2, 3), "b": (4, 5, 6, 7)},
        {"a": (0, 1), "b": (2, 3, 4), "c": (5, 6, 7)},
        {"a": tuple(range(8))},
        {"a": (0, 2, 4), "b": (1, 3)},
    ]
    sizes = [(4, 4, 0), (6, 2, 0), (2, 6, 0), (8, 0, 0), (3, 2, 3),
             (1, 1, 1), (0, 4, 4), (5, 0, 3)]
    for cur in currents:
        for a, b, c in sizes:
            target = {"a": a, "b": b}
            if c or "c" in cur:
                target["c"] = c
            yield cur, target


@pytest.mark.parametrize("cur,target", list(_plans()))
def test_plan_and_delta_equal_reference(cur, target):
    want = ref_composer.plan_recomposition(cur, target, 8)
    got = plan_recomposition(cur, target, 8)
    assert got == want
    rd = ref_composer.recomposition_delta(cur, want)
    d = recomposition_delta(cur, got)
    assert (d.unchanged, d.moved, d.admitted, d.evicted) == \
        (rd.unchanged, rd.moved, rd.admitted, rd.evicted)


def test_plan_rejects_what_the_reference_rejects():
    for bad in ({"a": 5, "b": 4}, {"a": 9}):
        with pytest.raises(ValueError):
            ref_composer.plan_recomposition({}, bad, 8)
        with pytest.raises(ValueError):
            plan_recomposition({}, bad, 8)


@pytest.mark.parametrize("total,parts", [(t, p) for t in (1, 2, 5, 8, 12)
                                         for p in (1, 2, 3, 4) if p <= t])
def test_compositions_equal_reference(total, parts):
    assert list(_compositions(total, parts)) == \
        list(ref_fabric._compositions(total, parts))


@pytest.mark.parametrize("num_cus,n", [(8, 2), (8, 3), (16, 4), (64, 8),
                                       (128, 5)])
def test_candidate_splits_equal_reference(num_cus, n):
    busy = [f"t{i}" for i in range(n)]
    for demand in ({t: float(i + 1) for i, t in enumerate(busy)},
                   {t: 1.0 for t in busy},
                   {t: float(10 ** (i % 3)) for i, t in enumerate(busy)}):
        assert list(_candidate_splits(num_cus, busy, demand)) == \
            list(ref_fabric._candidate_splits(num_cus, busy, demand))


def test_replica_and_tp_tiling_of_cu_ids():
    """The port's tp_submesh / replica_submesh tile a grant's CU ids as
    the reference's tile a mesh's model axis."""
    comp = composer.CUComposer(8, "cpu")
    sub = comp.submesh((1, 2, 3, 5, 6, 7), "t")
    assert composer.tp_submesh(sub, 4).cu_ids == (1, 2, 3, 5)
    assert composer.tp_submesh(sub, 8) is sub
    tiles = [composer.replica_submesh(sub, i, 3).cu_ids for i in range(3)]
    assert tiles == [(1, 2), (3, 5), (6, 7)]
    assert composer.replica_submesh(sub, 0, 4).share == 1 / 8
    with pytest.raises(ValueError):
        composer.replica_submesh(sub, 0, 7)
    assert comp.unified().cu_ids == tuple(range(8))
    assert [s.cu_ids for s in comp.compose([3, 5])] == \
        [(0, 1, 2), (3, 4, 5, 6, 7)]


# ---------------------------------------------------------------------------
# the reference's own plan and policy tests (tests/test_fabric.py), against
# the port
# ---------------------------------------------------------------------------

def test_plan_unchanged_tenants_keep_exact_cus():
    cur = {"a": (0, 1, 2, 3), "b": (4, 5, 6, 7)}
    new = plan_recomposition(cur, {"a": 4, "b": 4}, 8)
    assert new == cur
    assert recomposition_delta(cur, new) == \
        RecompositionDelta(("a", "b"), (), (), ())


def test_plan_grow_steals_only_from_shrunk_tenant():
    cur = {"a": (0, 1, 2, 3), "b": (4, 5, 6, 7)}
    new = plan_recomposition(cur, {"a": 6, "b": 2}, 8)
    assert set(cur["a"]) <= set(new["a"]) and len(new["a"]) == 6
    assert set(new["b"]) <= set(cur["b"]) and len(new["b"]) == 2
    assert not set(new["a"]) & set(new["b"])
    d = recomposition_delta(cur, new)
    assert set(d.moved) == {"a", "b"} and not d.unchanged


def test_plan_third_tenant_unaffected_by_neighbors():
    cur = {"a": (0, 1), "b": (2, 3, 4), "c": (5, 6, 7)}
    new = plan_recomposition(cur, {"a": 3, "b": 2, "c": 3}, 8)
    assert new["c"] == cur["c"]
    d = recomposition_delta(cur, new)
    assert "c" in d.unchanged and set(d.moved) == {"a", "b"}


def test_plan_park_and_admit():
    cur = {"a": (0, 1, 2, 3), "b": (4, 5, 6, 7)}
    new = plan_recomposition(cur, {"a": 8, "b": 0}, 8)
    assert new == {"a": (0, 1, 2, 3, 4, 5, 6, 7)}
    d = recomposition_delta(cur, new)
    assert d.evicted == ("b",) and d.moved == ("a",)
    back = plan_recomposition(new, {"a": 4, "b": 4}, 8)
    assert len(back["a"]) == len(back["b"]) == 4
    assert recomposition_delta(new, back).admitted == ("b",)


def test_compositions_enumerates_all_positive_splits():
    assert list(_compositions(5, 2)) == [(1, 4), (2, 3), (3, 2), (4, 1)]
    assert all(sum(s) == 8 for s in _compositions(8, 3))


def test_candidate_splits_proportional_fallback_at_pod_scale():
    busy = [f"t{i}" for i in range(8)]
    demand = {t: float(i + 1) for i, t in enumerate(busy)}
    splits = list(_candidate_splits(64, busy, demand))
    assert len(splits) == 1
    (s,) = splits
    assert sum(s) == 64 and all(x >= 1 for x in s)
    assert list(s) == sorted(s)


def _load(pending, active=1, util=0.0):
    return TenantObservation(pending_tokens=pending, queue_depth=0,
                             active=active, arena_utilization=util)


def _cus(points):
    return {t: p.cus for t, p in points.items() if p.cus > 0}


@pytest.mark.parametrize("platform", [TPU_NUMBERS, None],
                         ids=["tpu-numbers", "h100-eighth"])
def test_policy_gives_lone_busy_tenant_the_fabric(platform):
    cfgs = {"a": get_reduced("minitron-4b"), "b": get_reduced("minitron-4b")}
    points, reason = AnalyticalPolicy(platform).decide(
        {"a": _load(100), "b": _load(0)}, cfgs, {"a": 4, "b": 4}, 8)
    assert _cus(points) == {"a": 8} and reason == "unify"


@pytest.mark.parametrize("platform", [TPU_NUMBERS, None],
                         ids=["tpu-numbers", "h100-eighth"])
def test_policy_hysteresis_keeps_balanced_split(platform):
    cfgs = {"a": get_reduced("minitron-4b"), "b": get_reduced("minitron-4b")}
    points, reason = AnalyticalPolicy(platform).decide(
        {"a": _load(50), "b": _load(50)}, cfgs, {"a": 4, "b": 4}, 8)
    assert _cus(points) == {"a": 4, "b": 4} and reason == "hysteresis"


@pytest.mark.parametrize("platform", [TPU_NUMBERS, None],
                         ids=["tpu-numbers", "h100-eighth"])
def test_policy_admits_parked_tenant_with_new_work(platform):
    cfgs = {"a": get_reduced("minitron-4b"), "b": get_reduced("minitron-4b")}
    points, reason = AnalyticalPolicy(platform).decide(
        {"a": _load(10), "b": _load(10)}, cfgs, {"a": 8, "b": 0}, 8)
    assert reason == "admit" and _cus(points).get("b", 0) >= 1


def test_decide_legacy_keyword_form_is_gone():
    cfgs = {"a": get_reduced("minitron-4b"), "b": get_reduced("minitron-4b")}
    obs = {"a": _load(100), "b": _load(0)}
    with pytest.raises(TypeError):
        AnalyticalPolicy().decide(obs, cfgs, {"a": 4, "b": 4}, 8,
                                  classes={"a": "decode"})


# ---------------------------------------------------------------------------
# Stage 1 and design_key
# ---------------------------------------------------------------------------

def _space_kw(arch, slots=2, dp=1, tp_allowed=False, paged=True,
              use_kernels=True, max_len=64):
    cfg = get_reduced(arch)
    ssm = cfg.ssm is not None
    per_tok = (2 * cfg.num_kv_heads * cfg.resolved_head_dim
               * cfg.num_layers) if not ssm else 0
    per_slot = max_len * per_tok if not ssm else 4096 * cfg.num_layers
    return dict(wclass="ssm" if ssm else "decode", max_len=max_len,
                base_slots=slots, base_dp=dp, per_slot_elems=per_slot,
                tp_allowed=tp_allowed, slot_cap=64, dp_cap=64,
                prefill_bucket=0 if ssm else 32, use_kernels=use_kernels,
                paged=paged and not ssm, page_rows=16 if paged else 0,
                page_elems=16 * per_tok if paged and not ssm else 0)


def _stage1_pair(platform=TPU_NUMBERS):
    ref = ref_fabric.AnalyticalPolicy(REF_TPU).stage1
    got = AnalyticalPolicy(platform).stage1
    return ref, got


SPACE_CASES = [dict(slots=s, dp=d, tp_allowed=tp, paged=pg, use_kernels=uk)
               for s, d, tp, pg, uk in [(2, 1, False, True, True),
                                        (4, 2, False, True, True),
                                        (1, 1, True, False, True),
                                        (8, 1, False, False, False),
                                        (2, 4, True, True, False)]]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", range(len(SPACE_CASES)))
def test_stage1_best_and_cost_of_equal_reference(arch, case):
    ref, got = _stage1_pair()
    kw = _space_kw(arch, **SPACE_CASES[case])
    rsp = ref_dse.TenantDesignSpace(**kw)
    sp = dse.TenantDesignSpace(**kw)
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    lengths_grid = [(), (5, 9, 17, 33), tuple(range(3, 60, 4))]
    for conc, cus, lengths in itertools.product((1, 3, 8, 20), (1, 2, 5, 8),
                                                lengths_grid):
        want = ref.best(rcfg, rsp, conc, cus, lengths)
        have = got.best(cfg, sp, conc, cus, lengths)
        assert _pt(have) == _pt(want), (conc, cus, lengths)
        assert _close(have.cost, want.cost)
        for pt in (want, RefPoint(cus=cus), RefPoint(cus=cus, slots=1,
                                                     dp=1)):
            mine = DesignPoint(cus=pt.cus, tp=pt.tp, slots=pt.slots,
                               buckets=pt.buckets, dp=pt.dp)
            assert _close(got.cost_of(cfg, sp, conc, mine, lengths),
                          ref.cost_of(rcfg, rsp, conc, pt, lengths))


@pytest.mark.parametrize("design", [
    {"tp": None, "slots": 4, "buckets": None},
    {"tp": 2, "slots": 8, "buckets": (128, 512), "dp": 2},
    {"tp": None, "slots": 0, "buckets": (), "dp": None},
])
def test_design_key_equal_reference(design):
    for cus in (0, 1, 8):
        assert dse.design_key(cus, design) == ref_dse.design_key(cus, design)


def test_padded_factor_equal_reference():
    for ladder in ((64,), (16, 64), (8, 24, 64)):
        for lengths in ((), (5, 9, 17, 33), (64, 1, 63)):
            assert dse.padded_factor(ladder, lengths) == \
                ref_dse.padded_factor(ladder, lengths)


# ---------------------------------------------------------------------------
# AnalyticalPolicy.decide over a grid of observations
# ---------------------------------------------------------------------------

def _obs_pair(pending, queue, active, util, lengths, space_kw):
    kw = dict(pending_tokens=pending, queue_depth=queue, active=active,
              arena_utilization=util, recent_lengths=tuple(lengths))
    ref = ref_fabric.TenantObservation(
        space=ref_dse.TenantDesignSpace(**space_kw) if space_kw else None,
        **kw)
    got = TenantObservation(
        space=dse.TenantDesignSpace(**space_kw) if space_kw else None, **kw)
    return ref, got


def _current_pair(cur):
    ref, got = {}, {}
    for t, v in cur.items():
        if isinstance(v, tuple):          # (cus, slots, dp) as applied
            c, s, d = v
            ref[t] = RefPoint(cus=c, slots=s, dp=d)
            got[t] = DesignPoint(cus=c, slots=s, dp=d)
        else:
            ref[t] = got[t] = v
    return ref, got


def _decide_grid():
    loads = [(0, 0, 0, 0.0), (10, 0, 1, 0.0), (40, 3, 2, 0.5),
             (200, 6, 2, 0.9)]
    currents = [{"a": 4, "b": 4}, {"a": 8, "b": 0}, {"a": 1, "b": 7},
                {"a": (4, 2, 1), "b": (4, 2, 1)},
                {"a": (6, 1, 1), "b": (2, 8, 2)}]
    for la, lb in itertools.product(loads, loads):
        for cur in currents:
            yield la, lb, cur


@pytest.mark.parametrize("pair", [("minitron-4b", "falcon-mamba-7b"),
                                  ("minitron-4b", "minitron-4b")])
@pytest.mark.parametrize("two_stage", [True, False])
def test_decide_equals_reference_over_grid(pair, two_stage):
    """Same points, reason, runner_up and predicted makespans as the
    reference on every observation of the grid, with and without design
    spaces; the grid reaches every reason the two-stage policy gives."""
    ref_pol = ref_fabric.AnalyticalPolicy(REF_TPU, two_stage=two_stage)
    pol = AnalyticalPolicy(TPU_NUMBERS, two_stage=two_stage)
    rcfgs = {"a": ref_reduced(pair[0]), "b": ref_reduced(pair[1])}
    cfgs = {"a": get_reduced(pair[0]), "b": get_reduced(pair[1])}
    reasons = set()
    for la, lb, cur in _decide_grid():
        for with_space in (True, False):
            robs, obs = {}, {}
            for t, ld, slots in (("a", la, 1), ("b", lb, 2)):
                sk = (_space_kw(pair[t == "b"], slots=slots)
                      if with_space else None)
                robs[t], obs[t] = _obs_pair(*ld, (4, 9, 13, 20, 31),
                                            sk)
            rcur, gcur = _current_pair(cur)
            rp, rr = ref_pol.decide(robs, rcfgs, rcur, 8)
            gp, gr = pol.decide(obs, cfgs, gcur, 8)
            assert gr == rr, (la, lb, cur, with_space)
            _same_points(rp, gp)
            _same_points(ref_pol.runner_up, pol.runner_up)
            if ref_pol.predicted is None:
                assert pol.predicted is None
            else:
                assert set(pol.predicted) == set(ref_pol.predicted)
                for k, v in ref_pol.predicted.items():
                    w = pol.predicted[k]
                    assert (v is None) == (w is None)
                    assert v is None or _close(w, v)
            reasons.add(rr)
    want = {"idle", "admit", "hysteresis", "rebalance", "unify"}
    if two_stage:
        want.add("retune")
    assert want <= reasons, reasons


def test_fabric_memory_budget_is_a_share_of_what_weights_leave():
    """The fabric's Stage 1 bounds slots by one CU's share of the HBM the
    tenants' weights leave free (the port's rule; the reference keeps half
    of one chip's HBM per CU)."""
    srv = fabric.ComposedServer(
        [fabric.TenantSpec("a", "minitron-4b",
                           serve=fabric.ServeConfig(max_slots=2, max_len=32,
                                                    eos_id=-1))],
        num_cus=4, device="cpu", policy=AnalyticalPolicy(per_cu(H100_SXM,
                                                                4)))
    weights = fabric._param_bytes(srv.engines["a"].params)
    assert 0 < weights < 10**9
    assert srv.policy.stage1.mem_budget_bytes == \
        (H100_SXM.hbm_bytes - weights) / 4


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ref_traffic.PROFILES)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_arrival_schedule_equals_reference(profile, seed):
    assert traffic.PROFILES == ref_traffic.PROFILES
    for n, max_new in ((1, 16), (6, 8), (12, 32)):
        want = ref_traffic.arrival_schedule(profile, ["x", "y", "z"], n, seed,
                                            max_new=max_new)
        got = traffic.arrival_schedule(profile, ["x", "y", "z"], n, seed,
                                       max_new=max_new)
        assert [dataclasses.astuple(a) for a in got] == \
            [dataclasses.astuple(a) for a in want]
    with pytest.raises(ValueError):
        traffic.arrival_schedule("nope", ["x"], 1, 0)


@pytest.mark.parametrize("arch", ("minitron-4b", "falcon-mamba-7b",
                                  "qwen2.5-32b"))
def test_step_cost_equals_reference_for_every_class(arch):
    """The class-aware price, including the encoder and enc-dec rooflines
    whose engines are later slices of the port."""
    ref = ref_fabric.AnalyticalPolicy(REF_TPU)
    got = AnalyticalPolicy(TPU_NUMBERS)
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    for wclass in ("decode", "ssm", "encoder", "encdec"):
        for batch, cus, src, kv in itertools.product((1, 4, 16), (0, 1, 3, 8),
                                                     (0, 40), (0, 64)):
            want = ref.step_cost(rcfg, batch, cus, wclass, src_len=src,
                                 kv_len=kv)
            have = got.step_cost(cfg, batch, cus, wclass, src_len=src,
                                 kv_len=kv)
            assert _close(have, want), (wclass, batch, cus, src, kv)


def test_concurrent_groups_equal_reference():
    from repro.core import dse as ref_core_dse
    from repro_torch.core import dse as core_dse
    spans = [(0.0, 2.0, (0, 1)), (0.0, 1.0, (2,)), (1.0, 3.0, (2, 3)),
             (2.0, 4.0, (0,)), (5.0, 6.0, (1, 2, 3))]

    def plan(mod):
        layers = tuple(mod.PlannedLayer(i, f"l{i}", (8, 8, 8), 2, len(c),
                                        (8, 8, 8), a, b, (i,), c)
                       for i, (a, b, c) in enumerate(spans))
        return mod.ExecutionPlan("toy", layers, 6.0)

    want = ref_composer.concurrent_groups(plan(ref_core_dse))
    got = composer.concurrent_groups(plan(core_dse))
    assert [[pl.layer for pl in g] for g in got] == \
        [[pl.layer for pl in g] for g in want]
    assert len(got) == 4
