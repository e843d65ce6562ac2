"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs`` on the same observations: histogram merge, quantiles and
``fraction_below``, registry merge and snapshot, ``scoped`` / ``fresh`` /
``off``, the trace-event JSON shape and ``PredictionLedger.summary``."""
import json
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.obs as R  # noqa: E402
import repro_torch.obs as T  # noqa: E402


def _values(seed, n=200):
    rng = np.random.default_rng(seed)
    return [float(v) for v in rng.lognormal(-6.0, 1.5, size=n)] + [0.0, 1e-9]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_and_merge_equal_reference(seed):
    a, b = _values(seed), _values(seed + 10, 57)
    ra, rb, ta, tb = R.Histogram(), R.Histogram(), T.Histogram(), \
        T.Histogram()
    for v in a:
        ra.observe(v)
        ta.observe(v)
    for v in b:
        rb.observe(v)
        tb.observe(v)
    ra.merge(rb)
    ta.merge(tb)
    assert ta.counts == ra.counts and ta.count == ra.count
    assert (ta.sum, ta.min, ta.max) == (ra.sum, ra.min, ra.max)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ta.quantile(q) == ra.quantile(q)
    for x in (0.0, 1e-4, 2.5e-3, 1.0):
        assert ta.fraction_below(x) == ra.fraction_below(x)
    assert ta.snapshot() == ra.snapshot()
    assert math.isnan(T.Histogram().quantile(0.5))
    assert T.Histogram().snapshot() == {"count": 0}


def _fill(mod, reg, seed):
    rng = np.random.default_rng(seed)
    for i in range(40):
        t = "ab"[i % 2]
        reg.histogram("decode_step_s", tenant=t).observe(
            float(rng.uniform(1e-3, 2e-2)))
        reg.counter("tokens", tenant=t).inc(int(rng.integers(1, 9)))
        reg.gauge("queue_depth", tenant=t).set(float(rng.integers(0, 5)))
    reg.histogram("ttft_s", tenant="a", wclass="decode").observe(0.05)


def test_registry_merge_and_snapshot_equal_reference():
    rr, tr = R.MetricsRegistry.merged([]), T.MetricsRegistry.merged([])
    for seed in (3, 4):
        r, t = R.MetricsRegistry(), T.MetricsRegistry()
        _fill(R, r, seed)
        _fill(T, t, seed)
        rr.merge(r)
        tr.merge(t)
    assert tr.snapshot() == rr.snapshot()
    for match in ({}, {"tenant": "a"}, {"tenant": "b"}):
        assert tr.merged_histogram("decode_step_s", **match).counts == \
            rr.merged_histogram("decode_step_s", **match).counts
    assert set(tr.find_histograms("decode_step_s")) == \
        set(rr.find_histograms("decode_step_s"))
    assert json.loads(json.dumps(tr.snapshot())) == tr.snapshot()


def test_scoped_fresh_off_equal_reference():
    for mod in (R, T):
        base = mod.Telemetry()
        s = base.scoped(tenant="a", wclass="decode")
        assert s.registry is base.registry and s.tracer is base.tracer
        assert s.labels == (("tenant", "a"), ("wclass", "decode"))
        f = s.fresh()
        assert f.registry is not base.registry and f.labels == s.labels
        s.observe("x_s", 0.5)
        f.observe("x_s", 0.25)
        s.inc("n", 3)
        with s.timed("span", "y_s", k=1) as args:
            args["extra"] = 2
        assert base.registry.merged_histogram("x_s", tenant="a").count == 1
        assert f.registry.merged_histogram("x_s").count == 1
        off = mod.Telemetry.off()
        off.observe("x_s", 1.0)
        off.inc("n")
        with off.span("s"):
            pass
        assert not off.enabled and len(off.tracer) == 0
        assert off.registry.snapshot()["histograms"] == {}
    # the same record calls give the same snapshot shape
    r, t = R.Telemetry().scoped(tenant="z"), T.Telemetry().scoped(tenant="z")
    for h in (r, t):
        h.observe("q_s", 0.125)
        h.inc("c", 2)
        h.set_gauge("g", 4.0)
    rs, ts = r.registry.snapshot(), t.registry.snapshot()
    assert ts == rs


def test_trace_json_shape_equals_reference(tmp_path):
    shapes = []
    for mod in (R, T):
        tr = mod.SpanTracer(capacity=4)
        for i in range(6):
            with tr.span("step", i=i):
                pass
        tr.record("recompose", 0.0, 0.0, {"moved": ["a"]}, cat="recompose")
        doc = tr.to_json()
        path = tr.dump(str(tmp_path / f"{mod.__name__}.json"))
        assert json.load(open(path)) == json.loads(json.dumps(doc))
        ev = doc["traceEvents"]
        assert len(ev) == 4 and doc["displayTimeUnit"] == "ms"
        shapes.append([(sorted(e), e["ph"], e["name"], e.get("args"))
                       for e in ev])
    assert shapes[0] == shapes[1]


def test_prediction_ledger_summary_equals_reference():
    rl, tl = R.PredictionLedger(), T.PredictionLedger()
    rng = np.random.default_rng(5)
    plan = [("a", "decode", "c4-tp0-dp1-s2", 2e-3),
            ("a", "decode", "c7-tp0-dp1-s4", 1e-3),
            ("b", "ssm", "c1-tp0-dp1-s1", 5e-3),
            ("b", "ssm", "c2-tp0-dp1-s2", float("inf"))]
    for led in (rl, tl):
        for t, w, k, p in plan:
            led.commit(t, w, k, p)
    for _ in range(30):
        t, w, k, _ = plan[int(rng.integers(0, 3))]
        v = float(rng.uniform(5e-4, 8e-3))
        rl.observe(t, k, v, wclass=w)
        tl.observe(t, k, v, wclass=w)
    tl.observe("c", "c1-tp0-dp1-s1", 1e-3)
    rl.observe("c", "c1-tp0-dp1-s1", 1e-3)
    assert len(tl) == len(rl)
    assert tl.summary() == rl.summary()
    assert tl.summary()["aggregate"]["entries_with_both"] == 3
