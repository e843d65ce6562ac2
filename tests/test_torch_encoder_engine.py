"""Port parity for ``EncoderEngine`` (the encoder workload class) on
qwen2.5-reduced, falcon-mamba-7b reduced and seamless-reduced in fp32,
with the JAX init's weights carried over by ``params_from_jax``: the
reference's encoder tests (``tests/test_workloads.py``) on the port, and
the embeddings against the JAX ``EncoderEngine`` within 1e-5 of the
largest |value| (summation order only).

Bucket invariance is held to 1e-6 relative, not bitwise: a job's
embedding sums over keys and positions in an order that follows the
padded length.  The reference's own bitwise claim
(``test_encoder_embeddings_bucket_invariant``) does not hold on the
installed JAX either: its embeddings differ across ladders by about 2e-6
relative, so the port claims no more than the reference gives.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads import EncoderEngine as JaxEncoderEngine  # noqa: E402
from repro.workloads import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.dse import DesignPoint  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads import (ENCODER, EncoderEngine,  # noqa: E402
                                   ServeConfig, build_engine)
from repro_torch.workloads.base import Engine  # noqa: E402

ARCHS = ["qwen2.5-32b", "falcon-mamba-7b", "seamless-m4t-medium"]
FP32_TOL = 1e-5
BUCKET_TOL = 1e-6


def _pair(arch):
    jcfg = dataclasses.replace(jax_get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = strip(jm.init(jax.random.key(0)))
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


_PAIRS = {}


def _models(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = _pair(arch)
    return _PAIRS[arch]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jobs(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=L) for L in lengths]


def _run(eng, jobs):
    rids = [eng.submit(j) for j in jobs]
    emitted = []
    while eng.has_work:
        emitted.extend(eng.step())
    return rids, emitted, eng.results()


@pytest.mark.parametrize("arch", ARCHS)
def test_embeddings_equal_jax_engine(arch):
    """Bucketed batches (per-job buckets, more jobs than slots), each
    embedding within 1e-5 of the JAX engine's, the same bucket hits and
    the same emission order."""
    jm, jp, tm, tp = _models(arch)
    serve = dict(max_slots=2, max_len=32, len_buckets=(8, 16))
    jobs = _jobs(jm.cfg, (4, 6, 20, 3, 9, 32))
    jeng = JaxEncoderEngine(jm, jp, JaxServeConfig(**serve))
    teng = EncoderEngine(tm, tp, ServeConfig(**serve))
    jr, jem, jres = _run(jeng, jobs)
    tr, tem, tres = _run(teng, jobs)
    assert tr == jr and [r for r, _ in tem] == [r for r, _ in jem]
    for r in tr:
        assert len(tres[r]) == tm.cfg.d_model
        assert _rel(tres[r], jres[r]) <= FP32_TOL, r
    assert teng.stats()["bucket_hits"] == jeng.stats()["bucket_hits"]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_protocol(arch):
    _, _, tm, tp = _models(arch)
    eng = build_engine(ENCODER, tm, tp, ServeConfig(max_slots=1, max_len=16))
    assert isinstance(eng, EncoderEngine) and isinstance(eng, Engine)
    assert eng.workload_class == ENCODER
    assert eng.preempt_one() is None and eng.preempted_depth == 0
    assert eng.warm_compile(None) == 1 and eng.warm_compile(None) == 0


def test_bucketed_programs_match_full_capacity():
    """Causal stack: every job runs in its own smallest bucket and gives
    the full-capacity program's embedding (to the bucket tolerance)."""
    jm, _, tm, tp = _models("falcon-mamba-7b")
    jobs = _jobs(tm.cfg, (4, 6, 20, 3))

    def run(buckets):
        eng = EncoderEngine(tm, tp, ServeConfig(max_slots=2, max_len=32,
                                                len_buckets=buckets))
        return eng, _run(eng, jobs)[2]

    full, fres = run(())
    bucketed, bres = run((8, 16))
    assert full.stats()["bucket_hits"] == {"32": 4}
    assert bucketed.stats()["bucket_hits"] == {"8": 3, "16": 0, "32": 1}
    for r in fres:
        assert _rel(bres[r], fres[r]) <= BUCKET_TOL


def test_bucket_is_per_job_not_per_batch():
    """Co-batching a short job with a long one leaves its bucket, and so
    its bidirectional embedding, as it was alone."""
    _, _, tm, tp = _models("seamless-m4t-medium")
    sc = ServeConfig(max_slots=2, max_len=32, len_buckets=(8,))
    short = np.arange(1, 5) % tm.cfg.vocab_size
    long = np.arange(1, 21) % tm.cfg.vocab_size
    alone = EncoderEngine(tm, tp, sc)
    r_alone = alone.submit(short)
    alone.run_to_completion(10)
    both = EncoderEngine(tm, tp, sc)
    r_both = both.submit(short)
    both.submit(long)
    both.run_to_completion(10)
    assert both.results()[r_both] == alone.results()[r_alone]
    assert both.stats()["bucket_hits"] == {"8": 1, "32": 1}


def test_embeddings_bucket_invariant_to_tolerance():
    """The bidirectional encoder masks each row's own padding: the same
    job's embedding under three ladders agrees to 1e-6 relative (see the
    module docstring for why not bitwise)."""
    _, _, tm, tp = _models("seamless-m4t-medium")
    job = np.arange(1, 6) % tm.cfg.vocab_size

    def run(buckets):
        eng = EncoderEngine(tm, tp, ServeConfig(max_slots=2, max_len=32,
                                                len_buckets=buckets))
        rid = eng.submit(job)
        eng.run_to_completion(10)
        return eng.results()[rid]

    a, b, full = run((8,)), run((16,)), run(())
    assert _rel(a, full) <= BUCKET_TOL and _rel(b, full) <= BUCKET_TOL


def test_rejections_not_counted_as_throughput():
    _, _, tm, tp = _models("falcon-mamba-7b")
    enc = EncoderEngine(tm, tp, ServeConfig(max_slots=2, max_len=8))
    ok = enc.submit(np.arange(1, 6))
    bad = enc.submit(np.arange(1, 30))          # 29 tokens > max_len
    emitted = []
    while enc.has_work:
        emitted.extend(enc.step())
    assert [r for r, _ in emitted] == [ok]
    assert enc.results()[bad] == []
    assert len(enc.results()[ok]) == tm.cfg.d_model
    assert enc.stats()["seqs_done"] == 1


def test_apply_swaps_the_ladder_live():
    """apply(buckets) swaps the ladder between steps (hits carried over),
    apply(slots) the jobs per step; warm_compile of a candidate ladder
    builds its buckets ahead, so the swap builds nothing."""
    _, _, tm, tp = _models("qwen2.5-32b")
    eng = EncoderEngine(tm, tp, ServeConfig(max_slots=2, max_len=32))
    jobs = _jobs(tm.cfg, (5, 12, 7))
    eng.submit(jobs[0])
    eng.step()
    assert eng.design()["buckets"] == (32,)
    point = DesignPoint(cus=1, buckets=(8, 16), slots=3)
    assert eng.warm_compile(None, point) == 3
    assert eng.apply(None, point) == {"slots": 3, "buckets": (8, 16, 32)}
    builds = eng.compile_builds
    for j in jobs[1:]:
        eng.submit(j)
    out = eng.step()
    assert len(out) == 2 and eng.compile_builds == builds
    assert eng.stats()["bucket_hits"] == {"8": 1, "16": 1, "32": 1}
    assert eng.apply(None, DesignPoint(cus=1, buckets=(8, 16))) == {}


def test_evacuate_and_adopt_move_the_queue():
    """Jobs hold no device state between steps: evacuate hands back the
    queue (no live requests), a sibling adopts it under fresh rids, and
    the adopted jobs' embeddings equal an uninterrupted run's."""
    _, _, tm, tp = _models("seamless-m4t-medium")
    sc = ServeConfig(max_slots=2, max_len=32, len_buckets=(8,))
    jobs = _jobs(tm.cfg, (5, 9, 3, 14))
    ref = EncoderEngine(tm, tp, sc)
    ref_rids, _, ref_res = _run(ref, jobs)

    src = EncoderEngine(tm, tp, sc)
    rids = [src.submit(j) for j in jobs]
    src.step()                                   # the first two finish
    live, queued = src.evacuate()
    assert live == [] and len(queued) == 2 and not src.has_work
    dst = EncoderEngine(tm, tp, sc)
    new = [dst.adopt_queued(j) for j in queued]
    assert new == [0, 1]
    dst.run_to_completion(10)
    moved = {**{r: src.results()[r] for r in rids[:2]},
             **{rids[2 + i]: dst.results()[n] for i, n in enumerate(new)}}
    assert moved == {r: ref_res[q] for r, q in zip(rids, ref_rids)}
    dst.submit(jobs[0])
    assert len(dst.export_queued()) == 1 and dst.queue_depth == 0
