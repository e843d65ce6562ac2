"""Port parity for the two attention kernels of ``repro_torch`` (the Mamba
kernels' plain versions are held against the JAX package in
``test_torch_ssm.py``) and the kernel build.

Each kernel's plain version against the JAX package's kernel in Pallas
interpret mode and against its pure-jnp oracle, on the same numpy inputs
(fp32, to 1e-5: summation order only), and the wrappers' CPU dispatch.
The kernels themselves are held against their plain versions on the card
in ``test_torch_kernels_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import mha  # noqa: E402
from repro.kernels.ragged_decode import ragged_decode_attention as jax_rd  # noqa: E402
from repro.models.layers import blockwise_attention as jax_blockwise  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.ragged_decode import ops as rd  # noqa: E402
from repro_torch.kernels.ragged_decode.ref import (  # noqa: E402
    ragged_decode_attention_ref, ragged_decode_partials,
    ragged_decode_split_ref)

RNG = np.random.default_rng(5)
FP32_TOL = 1e-5


def _qkv(B, Sq, Skv, Hq, Hkv, D):
    return (RNG.normal(size=(B, Sq, Hq, D)).astype(np.float32),
            RNG.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            RNG.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# ragged decode: plain version vs the Pallas kernel (interpret) and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("window,cap,glob", [
    (0, 0.0, None), (8, 0.0, False), (8, 0.0, True), (0, 20.0, None),
    (8, 20.0, False)])
def test_ragged_decode_plain_matches_jax(impl, window, cap, glob):
    B, T, Hq, Hkv, D = 5, 64, 6, 2, 16
    q, k, v = _qkv(B, 1, T, Hq, Hkv, D)
    lens = np.array([1, 17, 64, 40, 33], np.int32)
    live = np.array([True, True, True, False, True])
    kw = dict(window=window, logit_cap=cap, is_global=glob)
    want = jax_rd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lens), live=jnp.asarray(live), impl=impl, **kw)
    got = ragged_decode_attention_ref(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(lens), live=torch.tensor(live), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)
    assert (got[3] == 0).all()


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("chunk", [4, 16, 32, 64])
@pytest.mark.parametrize("window,cap,glob", [
    (0, 0.0, None), (8, 0.0, False), (8, 0.0, True), (8, 20.0, False)])
def test_ragged_decode_split_spec_matches_jax(impl, chunk, window, cap, glob):
    """The split kernel's plain spec against the plain version and the
    Pallas kernel.  At chunk 4 most chunks are empty (short rows, the
    window); window 8 starts inside a later chunk of the long rows."""
    B, T, Hq, Hkv, D = 5, 64, 6, 2, 16
    q, k, v = _qkv(B, 1, T, Hq, Hkv, D)
    lens = np.array([1, 17, 64, 40, 33], np.int32)
    live = np.array([True, True, True, False, True])
    kw = dict(window=window, logit_cap=cap, is_global=glob)
    want = jax_rd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lens), live=jnp.asarray(live), impl=impl, **kw)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    tl, tlive = torch.tensor(lens), torch.tensor(live)
    got = ragged_decode_split_ref(
        tq, tk, tv, tl, chunk=chunk, live=tlive, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)
    plain = ragged_decode_attention_ref(tq, tk, tv, tl, live=tlive, **kw)
    np.testing.assert_allclose(got.numpy(),
                               plain.numpy(), rtol=FP32_TOL, atol=FP32_TOL)
    assert (got[3] == 0).all()
    # empty chunks: past the length, before the window, a dead row
    m, l, acc = ragged_decode_partials(tq, tk, tv, tl, chunk=chunk,
                                       live=tlive, **kw)
    start = np.maximum(lens - window, 0) if window and not glob else 0 * lens
    lo = np.arange(-(-T // chunk)) * chunk
    empty = ((lo[None] + chunk <= start[:, None]) | (lo[None] >= lens[:, None])
             | ~live[:, None])
    assert empty.any() and not empty.all()
    e = torch.tensor(empty)[:, None, :].expand_as(l)
    assert (m[e] == -1e30).all() and (l[e] == 0).all()
    assert (acc[e] == 0).all() and (l[~e] > 0).all()


def test_split_plan_fills_the_card_from_host_ints():
    """The serving shape (8 slots, 8 KV heads, kv_bound 1056, 132 SMs)
    launches more than B * Hkv blocks; chunks are multiples of 32 that
    cover T; B = 1 at T = 2048 gives many splits."""
    chunk, n = rd.split_plan(8, 24, 8, 1056, 132)
    assert chunk % 32 == 0 and (n - 1) * chunk < 1056 <= n * chunk
    assert 8 * 8 * n > 2 * 132
    chunk, n = rd.split_plan(1, 24, 8, 2048, 132)
    assert n >= 32 and n * chunk >= 2048
    assert rd.split_plan(1, 1, 1, 1, 132) == (32, 1)


def test_ragged_decode_wrapper_takes_plain_on_cpu():
    q, k, v = (torch.tensor(a) for a in _qkv(3, 1, 32, 4, 2, 16))
    lens = torch.tensor([5, 32, 9], dtype=torch.int32)
    live = torch.tensor([True, False, True])
    before = rd.launches
    got = rd.ragged_decode_attention(q, k[:, :16], v[:, :16], lens.clamp(1, 16),
                                     live=live)
    want = ragged_decode_attention_ref(q, k[:, :16], v[:, :16],
                                       lens.clamp(1, 16), live=live)
    assert torch.equal(got, want)
    assert rd.launches == before


# ---------------------------------------------------------------------------
# prefill flash attention: plain version vs blockwise_attention and mha
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [37, 64])
@pytest.mark.parametrize("window,cap,glob", [(0, 0.0, None), (9, 0.0, False),
                                             (9, 25.0, True), (0, 25.0, None)])
def test_flash_plain_matches_blockwise(S, window, cap, glob):
    q, k, v = _qkv(2, S, S, 6, 2, 16)
    kw = dict(causal=True, window=window, logit_cap=cap, is_global=glob)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention_ref(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_plain_matches_pallas_interpret(window):
    q, k, v = _qkv(2, 64, 64, 4, 2, 16)
    want = mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
               window=window, impl="interpret")
    got = flash_attention_ref(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_flash_wrapper_takes_plain_on_cpu():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 40, 40, 4, 2, 16))
    before = fa.launches
    got = fa.flash_attention(q, k, v, window=7, logit_cap=10.0)
    assert torch.equal(got, flash_attention_ref(q, k, v, window=7,
                                                logit_cap=10.0))
    assert fa.launches == before


# ---------------------------------------------------------------------------
# the build: sources found, and no quiet fallback without a toolkit
# ---------------------------------------------------------------------------

def test_build_lists_sources_and_raises_without_nvcc(monkeypatch, tmp_path):
    names = sorted(p.name for p in _build.sources())
    assert names == ["common.cu", "filco_mm.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu", "mamba_scan.cu",
                     "ragged_decode.cu"]
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.library_path().name.startswith("librepro_torch_kernels-")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_build_compiles_each_source_links_once_and_caches(monkeypatch,
                                                          tmp_path):
    """The build orchestration with a stand-in for nvcc: one compile per
    source and one link, the compiler log kept, no rebuild while the
    sources are unchanged, and a failing source raises with its log."""
    calls = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo \"$*\" >> {calls}\n"
        "prev=''; out=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=\"$a\"; prev=\"$a\"; done\n"
        "echo 'ptxas info    : Used 8 registers'\n"
        "case \"$*\" in *\"$FAIL_ON\"*) [ -n \"$FAIL_ON\" ] && exit 1;; esac\n"
        ": > \"$out\"\n")
    stub.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "ok")
    monkeypatch.setenv("FAIL_ON", "")
    lib = _build.build()
    assert lib.exists() and lib.parent == tmp_path / "ok"
    lines = calls.read_text().splitlines()
    assert sum(" -c " in f" {ln} " for ln in lines) == len(_build.sources())
    assert sum("-shared" in ln for ln in lines) == 1
    assert all("arch=compute_90a,code=sm_90a" in ln for ln in lines)
    assert "== ragged_decode.cu (rc 0)" in lib.with_suffix(".log").read_text()
    assert _build.build() == lib
    assert len(calls.read_text().splitlines()) == len(lines)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "bad")
    monkeypatch.setenv("FAIL_ON", "flash_attention.cu")
    with pytest.raises(RuntimeError, match="flash_attention.cu"):
        _build.build()
    assert not _build.library_path().exists()
