"""Port parity for the enc-dec slice on seamless-reduced: the flash plain
version with per-row key padding, the bidirectional encoder, the
cross-attention functions, ``Model.encode``/``prefill``/``decode_step``
and ``EncDecEngine``, each against the JAX package on the same numpy
inputs, with the JAX init's weights carried over by ``params_from_jax``.

fp32: values within 1e-5 of the largest |value| (summation order only)
and token streams equal.  bf16: logits within BF16_LOGIT_TOL of the
largest |logit|, as ``test_torch_model.py`` holds them (bf16 rounds at
other points in the two frameworks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.distribution import strip  # noqa: E402
from repro.kernels.flash_attention import mha  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import blockwise_attention as jax_blockwise  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.workloads import EncDecEngine as JaxEncDecEngine  # noqa: E402
from repro.workloads import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.workloads import (ENCDEC, EncDecEngine,  # noqa: E402
                                   ServeConfig)
from repro_torch.workloads.base import Engine  # noqa: E402

ARCH = "seamless-m4t-medium"
FP32_TOL = 1e-5
BF16_LOGIT_TOL = 3e-2


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = strip(jm.init(jax.random.key(0)))
    tm = Model(tcfg, "cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def fp32():
    return _pair()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the flash kernel's plain version with per-row key padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 63, 65, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_kv_len_equals_jax_blockwise(S, causal):
    """Lengths in [0, S]: a row of length 0 (a batch row holding no job)
    included, as the engines pass it."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(4, S, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    lens = np.array([S, max(S // 2, 1), 0, 1], np.int32)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, kv_len=jnp.asarray(lens))
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                              kv_len=_t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("S", [1, 63, 65, 200])
def test_flash_plain_bidirectional_equals_pallas_interpret(S):
    rng = np.random.default_rng(S + 1)
    q, k, v = (rng.normal(size=(2, S, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
               impl="interpret")
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)


# ---------------------------------------------------------------------------
# encoder and cross-attention against the reference's functions
# ---------------------------------------------------------------------------

def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_fwd_matches_jax(fp32, masked):
    jm, jp, tm, tp = fp32
    B, S = 3, 21
    x = _x(jm.cfg, B, S)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    lens = np.array([21, 9, 1], np.int32) if masked else None
    want = JT.encoder_fwd(jp["encoder"], jm.cfg, jnp.asarray(x),
                          jnp.asarray(pos),
                          kv_len=None if lens is None else jnp.asarray(lens))
    got = T.encoder_fwd(tp["encoder"], tm.cfg, _t(x), _t(pos),
                        kv_len=None if lens is None else _t(lens))
    assert _rel(got, want) <= FP32_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_cross_fwd_matches_jax(fp32, masked):
    jm, jp, tm, tp = fp32
    jl = jax.tree.map(lambda a: a[0], jp["decoder"]["scanned"]["cross"])
    tl = tp["decoder"]["layers"][0]["cross"]
    x, enc = _x(jm.cfg, 2, 5, 1), _x(jm.cfg, 2, 13, 2)
    src = np.array([13, 6], np.int32) if masked else None
    want = JA.cross_fwd(jl, jm.cfg, jnp.asarray(x), jnp.asarray(enc), None,
                        src_len=None if src is None else jnp.asarray(src))
    got = A.cross_fwd(tl, tm.cfg, _t(x), _t(enc),
                      src_len=None if src is None else _t(src))
    assert _rel(got, want) <= FP32_TOL


def test_cross_kv_matches_jax(fp32):
    jm, jp, tm, tp = fp32
    jl = jax.tree.map(lambda a: a[1], jp["decoder"]["scanned"]["cross"])
    tl = tp["decoder"]["layers"][1]["cross"]
    enc = _x(jm.cfg, 2, 11, 3)
    jk, jv = JA.cross_kv(jl, jm.cfg, jnp.asarray(enc))
    tk, tv = A.cross_kv(tl, tm.cfg, _t(enc))
    assert _rel(tk, jk) <= FP32_TOL and _rel(tv, jv) <= FP32_TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cross_step_matches_jax(fp32, use_kernels):
    """The plain path, and the kernel path, whose wrapper takes the plain
    ragged decode on the CPU, over a bounded prefix of the cross cache."""
    jm, jp, tm, tp = fp32
    jl = jax.tree.map(lambda a: a[0], jp["decoder"]["scanned"]["cross"])
    tl = tp["decoder"]["layers"][0]["cross"]
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    x1 = _x(cfg, 3, 1, 5)
    ck, cv = (rng.normal(size=(3, 48, cfg.num_kv_heads,
                               cfg.resolved_head_dim)).astype(np.float32)
              for _ in range(2))
    src = np.array([40, 17, 1], np.int32)
    bound = 40                          # covers every live row's source
    live = np.array([True, True, False])
    want = JA.cross_step(jl, cfg, jnp.asarray(x1), jnp.asarray(ck),
                         jnp.asarray(cv), jnp.asarray(src))
    got = A.cross_step(tl, tm.cfg, _t(x1), _t(ck), _t(cv), _t(src),
                       use_kernels=use_kernels,
                       src_bound=bound if use_kernels else None,
                       live=_t(live) if use_kernels else None)
    rows = [0, 1] if use_kernels else [0, 1, 2]
    assert _rel(got[rows], np.asarray(want)[rows]) <= FP32_TOL


# ---------------------------------------------------------------------------
# the model: encode, prefill from an encoder output, decode steps
# ---------------------------------------------------------------------------

def test_model_encode_prefill_decode_match_jax(fp32):
    jm, jp, tm, tp = fp32
    cfg = jm.cfg
    rng = np.random.default_rng(6)
    B, S = 2, 24
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([24, 10], np.int32)
    jenc = jm.encode(jp, {"tokens": jnp.asarray(toks)},
                     lens=jnp.asarray(lens))
    tenc = tm.encode(tp, {"tokens": _t(toks)}, lens=_t(lens))
    assert _rel(tenc, jenc) <= FP32_TOL
    dec = np.array([[1, 7, 9, 0]], np.int32)
    for b in range(B):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(dec)},
                            strip(jm.init_cache(1, 16, src_len=S)),
                            enc_out=jenc[b:b + 1], src_len=int(lens[b]),
                            true_len=3)
        tl, tc = tm.prefill(tp, {"tokens": _t(dec)},
                            tm.init_cache(1, 16, src_len=S),
                            enc_out=tenc[b:b + 1], src_len=int(lens[b]),
                            true_len=3, use_kernels=False)
        assert _rel(tl, jl) <= FP32_TOL
        assert tc["src_len"].tolist() == [int(lens[b])]
        for _ in range(4):
            nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
            assert tl.numpy().argmax(-1).tolist() == nxt[:, 0].tolist()
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
            tl, tc = tm.decode_step(tp, tc, _t(nxt))
            assert _rel(tl, jl) <= FP32_TOL


def test_bf16_logits_within_tolerance():
    jm, jp, tm, tp = _pair("bfloat16")
    rng = np.random.default_rng(7)
    S = 19
    toks = rng.integers(1, jm.cfg.vocab_size, size=(1, S)).astype(np.int32)
    jenc = jm.encode(jp, {"tokens": jnp.asarray(toks)})
    tenc = tm.encode(tp, {"tokens": _t(toks)})
    dec = np.array([[1]], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(dec)},
                        strip(jm.init_cache(1, 16, src_len=S)), enc_out=jenc,
                        src_len=S)
    tl, tc = tm.prefill(tp, {"tokens": _t(dec)},
                        tm.init_cache(1, 16, src_len=S), enc_out=tenc,
                        src_len=S, use_kernels=False)
    assert _rel(tl.float(), jl) <= BF16_LOGIT_TOL
    for _ in range(3):
        nxt = np.asarray(jl.astype(jnp.float32)).argmax(-1)
        nxt = nxt.astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, _t(nxt))
        assert _rel(tl.float(), jl) <= BF16_LOGIT_TOL


# ---------------------------------------------------------------------------
# EncDecEngine against the JAX EncDecEngine
# ---------------------------------------------------------------------------

def _engines(fp32, **serve):
    jm, jp, tm, tp = fp32
    return (JaxEncDecEngine(jm, jp, JaxServeConfig(**serve)),
            EncDecEngine(tm, tp, ServeConfig(**serve)))


def _serve(eng, jobs):
    rids = [eng.submit(src, max_new_tokens=new, **kw)
            for src, new, kw in jobs]
    out = eng.run_to_completion(400)
    return [out[r] for r in rids], eng.stats()["bucket_hits"]


@pytest.mark.parametrize("kind", ["bos", "prefix", "frames"])
def test_engine_streams_equal_jax_engine(fp32, kind):
    """[bos] prompts, forced prefixes and precomputed frames, through
    bucketed encodes (two ladders' worth of lengths) and paged slots, on
    the plain path and the kernel path (whose wrappers take the plain
    versions on the CPU)."""
    jm, jp, tm, tp = fp32
    rng = np.random.default_rng(8)
    jobs = []
    for L, new in ((5, 6), (7, 4), (11, 8), (3, 5), (12, 3)):
        src = rng.integers(1, jm.cfg.vocab_size, size=L)
        kw = {}
        if kind == "prefix":
            kw["prefix"] = rng.integers(1, jm.cfg.vocab_size,
                                        size=int(rng.integers(1, 5)))
        if kind == "frames":
            src = np.asarray(jp["embed"])[src]
        jobs.append((src, new, kw))
    serve = dict(max_slots=2, max_len=24, eos_id=-1, max_src_len=12,
                 len_buckets=(8,))
    jeng, teng = _engines(fp32, **serve)
    want, jhits = _serve(jeng, jobs)
    got, thits = _serve(teng, jobs)
    assert got == want and thits == jhits
    assert [len(s) for s in got] == [6, 4, 8, 5, 3]
    plain = EncDecEngine(tm, tp, ServeConfig(**serve, use_kernels=False))
    assert _serve(plain, jobs)[0] == want


def test_engine_backpressure_matches_jax(fp32):
    """A one-job arena: the second job waits on the source-cache rows, as
    in the reference; oversized sources are rejected but recorded."""
    jm, jp, tm, tp = fp32
    from repro.core.arena import FlexArena as JaxFlexArena
    from repro_torch.core.arena import FlexArena
    serve = dict(max_slots=2, max_len=16, eos_id=-1, max_src_len=8)
    jeng, teng = _engines(fp32, **serve)
    rows = 8 + 1 + 7
    jeng.arena = JaxFlexArena(rows * jeng._per_token_elems)
    teng.arena = FlexArena(rows * teng._per_token_elems)
    rng = np.random.default_rng(9)
    srcs = [rng.integers(1, jm.cfg.vocab_size, size=8) for _ in range(2)]
    trace = []
    for eng in (jeng, teng):
        rids = [eng.submit(s, max_new_tokens=7) for s in srcs]
        eng.step()
        occ = (eng.active_count, eng.queue_depth)
        big = eng.submit(rng.integers(1, 200, size=9), max_new_tokens=2)
        out = eng.run_to_completion(200)
        trace.append((occ, [out[r] for r in rids], out[big]))
    assert trace[1] == trace[0]
    assert trace[0][0] == (1, 1) and trace[0][2] == []


def test_engine_protocol_and_class(fp32):
    _, _, tm, tp = fp32
    eng = EncDecEngine(tm, tp, ServeConfig(max_slots=1, max_len=16,
                                           eos_id=-1, max_src_len=8))
    assert isinstance(eng, Engine) and eng.workload_class == ENCDEC
    qcfg = get_reduced("qwen2.5-32b")
    with pytest.raises(ValueError):
        EncDecEngine(Model(qcfg, "cpu"), None, ServeConfig())


def test_engine_decode_bounds_and_warm_set(fp32):
    """Decode entries are keyed by both bounds (decoder KV, source), and
    warm_compile builds both bounds' steps, one block above and at full
    capacity, before any step dispatches; serving then builds nothing."""
    _, _, tm, tp = fp32
    eng = EncDecEngine(tm, tp, ServeConfig(max_slots=2, max_len=48,
                                           eos_id=-1, max_src_len=40,
                                           len_buckets=(16,)))
    assert eng._full_bounds() == (48, 40)
    rng = np.random.default_rng(10)
    eng.submit(rng.integers(1, 200, size=20), max_new_tokens=3)
    eng.warm_compile(None)
    keys = {k[3] for k in eng._exec._exe if k[0] == "decode"}
    assert {(32, 32), (48, 40)} <= keys
    builds = eng.compile_builds
    eng.step()
    assert eng._decode_bounds() == (32, 32)
    eng.run_to_completion(50)
    assert eng.compile_builds == builds
