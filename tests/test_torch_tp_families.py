"""Tensor-parallel serving of the SSM, hybrid and MoE/MLA decoders on the
CPU, the port against the reference: falcon-mamba-reduced (attention-free
Mamba, d_in 128), hymba-reduced (4 query heads on 2 KV heads beside a
Mamba block in every layer) and deepseek-v2-lite-reduced (MLA on 4 heads,
4 routed experts top-2, a shared expert, a dense first layer), all fp32.
The reference's mesh scenarios run in one subprocess on 8 fake JAX
devices (meshes with ``AxisType.Auto``), the port's in one gloo world of
8 CPU ranks (``tests/_torch_tp_worker.py ... families``: one thread per
rank, a ``file://`` rendezvous of its own).  Each side runs once per
module; every test reads the two runs.  Parameters cross with
``repro_torch.bridge`` from the reference's ``model.init(jax.random.key
(0))``.

(a) Greedy streams at TP 1 (replicated), 2, 4 and 8 (where the experts and
    hymba's heads stay whole) and across the reference's reshard script
    {3: 1, 7: 4, 11: 2} from TP 2 (``tests/test_workloads.py``'s SSM test)
    equal the reference's and the port's unsharded engine's.  The
    reference serves at TP 1 and across the script, which starts at TP 2
    (its own tests pin its streams across degrees); at 2, 4 and 8 it
    builds its engines for their shard shapes.
(b) The first decode step's logits at TP 2, 4 and 8 within 1e-5 of the
    unsharded ones, relative to the largest |logit|.
(c) Every leaf's local shape equals the reference's shard shape at each
    degree, and each rank's ``in_proj`` is the x columns then the z
    columns of its own channels.
(d) bf16 at TP 2 within 3e-2 of unsharded; streams part only at top-2
    margins under 5e-2 (counted).
(e) An SSM tenant and a hybrid tenant on ``ComposedServer(mesh=...,
    tp=True)``, recomposed 4 + 4 -> 6 + 2 mid-stream: the reference's
    events and streams.
(f) Every arch builds the engine of its own workload class, and an
    ``EncoderEngine`` that encodes one job, under
    ``serve_engine_rules()``.
(g) On the CPU alone: the staged plain Mamba step on the ranks' shards of
    TP 2, 4 and 8, its two sums added here, equals the fused plain step
    within 1e-6 in fp32, dead rows untouched.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("falcon-mamba-7b", "hymba-1.5b", "deepseek-v2-lite-16b")
LOGIT_FP32_TOL = 1e-5
LOGIT_BF16_TOL = 3e-2          # tests/test_torch_model.py's
NEAR_TIE = 5e-2
STAGED_TOL = 1e-6

_REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses
import jax, numpy as np
from jax.sharding import AxisType
import repro.serve.fabric as F
from repro.configs import get_reduced
from repro.core.composer import MeshComposer
from repro.distribution import strip
from repro.models import build_model
from repro.serve import ServeConfig, ServeEngine, serve_engine_rules
from repro.workloads import SSMEngine

mesh = jax.make_mesh((1, 8), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
comp = MeshComposer(mesh)
sc = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
rng = np.random.default_rng(0)
out = {"prompts": [rng.integers(1, 256, size=L) for L in (5, 9, 7)]}
rules = serve_engine_rules()
ENGINES = {"falcon-mamba-7b": SSMEngine, "hymba-1.5b": ServeEngine,
           "deepseek-v2-lite-16b": ServeEngine}

def fp32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")

def shard_shapes(tree):
    return jax.tree.map(lambda a: tuple(a.sharding.shard_shape(a.shape)),
                        tree)

def engine(cls, model, params, tp, rules, shapes=None):
    eng = cls(model, params, sc, mesh=comp.submesh(range(tp), f"tp{tp}"),
              rules=rules)
    if shapes is not None:
        shapes[tp] = (shard_shapes(eng.params), shard_shapes(eng.cache))
    return eng

def run(cls, model, params, tp, rules, script=None, shapes=None):
    eng = engine(cls, model, params, tp, rules, shapes)
    for p in out["prompts"]:
        eng.submit(p, max_new_tokens=10)
    step = 0
    while eng.has_work:
        if script and step in script:
            eng.reshard_to(comp.submesh(range(script[step]), "re"))
        eng.step()
        step += 1
        assert step < 200
    return {r: list(map(int, t)) for r, t in eng.results().items()}

models = {}
for arch in ENGINES:
    model = build_model(fp32(arch))
    params = model.init(jax.random.key(0))
    models[arch] = (model, params)
    out[arch, "params"] = jax.tree.map(np.asarray, strip(params))

# the fabric: an SSM tenant and a hybrid tenant
F.get_reduced = fp32
fsc = F.ServeConfig(max_slots=2, max_len=32, eos_id=-1)
srv = F.ComposedServer(mesh, [F.TenantSpec("s", "falcon-mamba-7b", seed=0,
                                           serve=fsc),
                              F.TenantSpec("h", "hymba-1.5b", seed=1,
                                           serve=fsc)], policy=None)
for n in "sh":
    out["fabric", n] = jax.tree.map(np.asarray,
                                    strip(srv.engines[n].params))
# the port's side starts from the prompts and the initial parameters
with open(sys.argv[2] + ".part", "wb") as f:
    pickle.dump(out, f)
os.rename(sys.argv[2] + ".part", sys.argv[2])

for arch, cls in ENGINES.items():
    model, params = models[arch]
    out[arch, 1] = run(cls, model, strip(params), 1, None)
    shapes = {}
    for tp in (2, 4, 8):
        engine(cls, model, params, tp, rules, shapes)
    out[arch, "shapes"] = shapes
    out[arch, "dyn"] = run(cls, model, params, 2, rules,
                           {3: 1, 7: 4, 11: 2})

# the fabric's traffic and a manual recomposition
rids = []
for n in "sh":
    for p in out["prompts"][:2]:
        rids.append((n, srv.submit(n, p, max_new_tokens=10)))
for _ in range(3):
    srv.step()
srv.recompose({"s": 6, "h": 2})
res = srv.drain()
out["fabric_events"] = [[e.step, e.reason, e.sizes_after, e.design,
                         list(e.moved), list(e.unchanged)]
                        for e in srv.events]
out["fabric_streams"] = [[n, r, list(map(int, res[n][r]))]
                         for n, r in rids]
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): each side's results, one run each.  The port's
    side starts as soon as the reference has written its prompts and
    initial parameters (``init.pkl``), and the two run side by side."""
    d = tmp_path_factory.mktemp("tpf")
    ref_path, init_path, port_path = (d / "ref.pkl", d / "init.pkl",
                                      d / "port.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    logs = [open(d / n, "w+") for n in ("ref.log", "port.log")]
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(ref_path),
                            str(init_path)], cwd=ROOT, env=env,
                           stdout=logs[0], stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 600
    while not init_path.exists() and ref.poll() is None:
        assert time.monotonic() < deadline, "reference: no init.pkl"
        time.sleep(0.2)
    port = None
    if init_path.exists():
        port = subprocess.Popen([sys.executable,
                                 str(ROOT / "tests" / "_torch_tp_worker.py"),
                                 str(init_path), str(port_path), "families"],
                                cwd=ROOT, env=env, stdout=logs[1],
                                stderr=subprocess.STDOUT)
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 1))
               if p is not None else None for p in (ref, port)]
    finally:
        for p in (ref, port):
            if p is not None and p.poll() is None:
                p.kill()
    text = []
    for f in logs:
        f.seek(0)
        text.append(f.read()[-6000:])
        f.close()
    assert rcs == [0, 0], (rcs, text)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(port_path, "rb") as f:
        port = pickle.load(f)
    return ref, port


def _streams(d):
    return {int(r): [int(t) for t in toks] for r, toks in d.items()}


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("run", ["1", "2", "4", "8", "dyn"])
def test_streams_equal_reference_and_unsharded(runs, arch, run):
    ref, port = runs
    key = int(run) if run.isdigit() else run
    want = _streams(ref[arch, 1])
    assert len(want) == 3 and all(len(t) == 10 for t in want.values())
    if (arch, key) in ref:
        assert _streams(ref[arch, key]) == want
    assert _streams(port[arch, key]) == want
    assert _streams(port[arch, "unsharded"]) == want


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_first_step_logits_equal_unsharded(runs, arch, tp):
    _, port = runs
    got = port["logits", arch, tp]
    assert got["prefill"] <= LOGIT_FP32_TOL
    assert got["decode"] <= LOGIT_FP32_TOL


def _flat(tree, path=()):
    """{path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in
                _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and not all(
            isinstance(n, int) for n in tree)):
        return {k: v for i, t in enumerate(tree) for k, v in
                _flat(t, path + (i,)).items()}
    return {path: tuple(tree)}


def _reference_local_shapes(ref_tree, n_layers):
    """The reference's shard shapes in the port's tree structure: each
    scanned leaf, less its leading "layers" axis, once per layer."""
    out = {}
    for path, shape in _flat(ref_tree).items():
        if len(path) > 1 and path[0] == "decoder" and path[1] == "scanned":
            for i in range(n_layers):
                out[("decoder", "layers", i) + path[2:]] = shape[1:]
        else:
            out[path] = shape
    return out


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_local_shapes_equal_reference_shards(runs, arch, tp):
    """Every param leaf's local shape is the reference's shard shape, and
    every SSM cache leaf's (conv window and state on d_in)."""
    ref, port = runs
    params, cache = ref[arch, "shapes"][tp]
    mine = port["shapes", arch, tp]
    n_scan = mine["n_scanned"]
    assert _reference_local_shapes(params, n_scan) == mine["params"]
    want = {p: s for p, s in _flat(cache).items() if "ssm" in p}
    assert want == {p: s for p, s in mine["cache"].items() if "ssm" in p}
    assert mine["in_proj_xz"] is True


def test_in_proj_split_differs_from_a_contiguous_slice(runs):
    """By design: at TP 2 the reference's shard of ``in_proj`` is its
    first d_in columns (all x), the port's the x and z columns of its own
    channels; same shape, other content."""
    _, port = runs
    got = port["in_proj_tp2"]
    assert got["shape_equal"] and not got["content_equal_contiguous"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_tp2_within_tolerance_and_partings_at_near_ties(runs, arch):
    _, port = runs
    got = port["bf16", arch]
    assert got["logits"] <= LOGIT_BF16_TOL
    assert got["margins"] == [] or max(got["margins"]) < NEAR_TIE
    assert got["partings"] == len(got["margins"]) <= 3


def test_fabric_ssm_and_hybrid_tenants_recompose(runs):
    ref, port = runs
    got = port["fabric"]
    assert got["ranks_before"] == {"s": 4, "h": 4}
    assert got["ranks_after"] == {"s": 6, "h": 2}
    assert got["ruled"] == {"s": True, "h": True}
    assert got["events"] == ref["fabric_events"]
    assert got["streams"] == ref["fabric_streams"]


def test_decoder_only_archs_take_tp_rules_encdec_raise(runs):
    """Every arch, the enc-dec one included, builds the engine of its own
    class under the rules, and an ``EncoderEngine`` of every arch encodes
    a job under them (the enc-dec and encoder steps no longer raise; the
    name is kept from when they did)."""
    from repro_torch.configs import ARCH_IDS

    _, port = runs
    got = port["admitted"]
    assert got["raised"] == {}, got["raised"]
    assert set(got["built"]) == set(ARCH_IDS)
    assert set(got["built"].values()) == {"DecodeEngine", "SSMEngine",
                                          "EncDecEngine"}
    assert got["built"]["seamless-m4t-medium"] == "EncDecEngine"
    assert got["encoded"] == {arch: True for arch in ARCH_IDS}


def _mamba_case(B, d, d_in, R, N, w, seed):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=gen) * scale
    x1 = rnd(B, 1, d)
    conv, h = rnd(B, w - 1, d_in), rnd(B, d_in, N)
    weights = {"in_proj": rnd(d, 2 * d_in, scale=d ** -0.5),
               "conv_w": rnd(w, d_in, scale=w ** -0.5),
               "conv_b": rnd(d_in, scale=0.1),
               "x_proj": rnd(d_in, R + 2 * N, scale=d_in ** -0.5),
               "dt_proj": rnd(R, d_in, scale=R ** -0.5),
               "dt_bias": rnd(d_in, scale=0.5) - 4.0,
               "A_log": torch.log(torch.arange(1, N + 1.0)).expand(
                   d_in, N).contiguous(),
               "D": torch.ones(d_in),
               "out_proj": rnd(d_in, d, scale=d_in ** -0.5)}
    return x1, conv, h, weights


_ORDER = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
          "A_log", "D", "out_proj")


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("width", ["falcon", "hymba"])
def test_staged_plain_step_sums_equal_fused(width, tp):
    """The ranks' stage A, their x_proj sums added here, their stage B,
    their out_proj sums added and the finish, on shards sliced by the
    port's own ``model_dim``/``TPShard.local``, against the fused plain
    step on the whole block: output and the gathered conv window and
    state within 1e-6 in fp32; dead rows keep their state bit for bit
    and output zeros.  Widths: a sixteenth of falcon-mamba-7b's (d 256,
    d_in 512, R 16) and of hymba-1.5b's (d 100, d_in 200, R 7), N 16."""
    from repro_torch.configs import get_reduced
    from repro_torch.distribution import partitioning as part
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import mamba_step_ref
    from repro_torch.models.ssm import mamba_specs

    dims = {"falcon": (256, 512, 16), "hymba": (100, 200, 7)}[width]
    d, d_in, R = dims
    B, N, w = 8, 16, 4
    x1, conv, h, wts = _mamba_case(B, d, d_in, R, N, w, seed=tp)
    live = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool)
    args = [wts[k] for k in _ORDER]
    want, want_conv, want_h = mamba_step_ref(x1, conv, h, *args, live=live)
    rules = part.serve_engine_rules()
    specs = mamba_specs(get_reduced("falcon-mamba-7b"))
    shards = [part.TPShard(None, tuple(range(tp)), True, tp, i)
              for i in range(tp)]
    wdim = {k: part.model_dim(specs[k], wts[k].shape, rules, tp)
            for k in _ORDER}
    assert all(wdim[k] is not None for k in _ORDER)
    convs = [s.local(conv, 2) for s in shards]
    hs = [s.local(h, 1) for s in shards]
    before = [(c.clone(), hh.clone()) for c, hh in zip(convs, hs)]
    stages = [ops.mamba_step_stage_a(x1, c, hh,
                                     *[s.local(wts[k], wdim[k])
                                       for k in _ORDER], live=live)
              for s, c, hh in zip(shards, convs, hs)]
    dbc = sum(st[0] for st in stages)
    out_sum = sum(ops.mamba_step_stage_b(dbc, st[1]) for st in stages)
    got = ops.mamba_step_finish(out_sum, stages[0][1])
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= STAGED_TOL * scale
    assert torch.allclose(torch.cat(convs, 2), want_conv, rtol=0,
                          atol=STAGED_TOL * float(want_conv.abs().max()))
    assert torch.allclose(torch.cat(hs, 1), want_h, rtol=0,
                          atol=STAGED_TOL * float(want_h.abs().max()))
    dead = ~live
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    for (c0, h0), c, hh in zip(before, convs, hs):
        assert torch.equal(c[dead], c0[dead]) and torch.equal(hh[dead],
                                                              h0[dead])


# (d_model, d_in, dt_rank) of the two Mamba blocks at full width
_WIDTHS = {"falcon": (4096, 8192, 256), "hymba": (1600, 3200, 100)}


@pytest.mark.parametrize("width", ["falcon", "hymba"])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_step_product_plans_at_rank_widths(width, tp, dtype):
    """``plan()`` and ``_product_plan`` at one rank's widths (falcon's d_in
    4096, 2048, 1024; hymba's 1600, 800, 400, which is no multiple of the
    64-column strips), 8 slots: every K row lies in exactly one split, no
    split is empty, a tensor-core plan's spans are whole 128-row stages
    and its blocks walk every (strip, split) item."""
    from repro_torch.kernels.mamba_scan import ops

    d, d_in, R = _WIDTHS[width]
    n, N, B = d_in // tp, 16, 8
    dt = getattr(torch, dtype)
    products = {"in_proj": (d, 2 * n), "x_proj": (n, R + 2 * N),
                "dt_proj": (R, n), "out_proj": (n, d)}
    for name, (K, cols) in products.items():
        w = torch.empty((K, cols), dtype=dt)
        p = ops._product_plan(B, K, cols, K, 0, w, 132)
        assert p.splits >= 1 and p.splits * p.span >= K, (name, p)
        assert (p.splits - 1) * p.span < K, (name, p)
        if p.route == ops._MMA:
            assert dtype == "bfloat16" and K % 8 == 0 and cols % 8 == 0
            assert p.span % ops._BK == 0, (name, p)
            assert p.items == -(-cols // ops._BN) * p.splits
            assert 1 <= p.grid <= p.items
            assert p.grid <= ops.resident(B) * 132
        else:
            assert p.grid == p.items == 0


@pytest.mark.parametrize("d_in", [8192, 4096, 2048, 1024, 3200, 1600, 800,
                                  400])
@pytest.mark.parametrize("B", [1, 8])
def test_scan_plan_at_rank_widths(d_in, B):
    """``scan_plan`` at the whole and the ranks' channel counts: whole
    warps of N / 4 lanes a channel, every channel in one block, and no
    block count that another channel width would spread more evenly."""
    from repro_torch.kernels.mamba_scan import ops

    N, sms = 16, 132
    p = ops.scan_plan(B, d_in, N, sms)
    assert p.channels in ops._SCAN_CHANNELS
    assert p.channels * N // ops._SCAN_STATES % 32 == 0
    assert p.blocks == -(-d_in // p.channels)
    assert (p.blocks - 1) * p.channels < d_in
    assert p.grid == B * p.blocks and p.per_sm == -(-p.grid // sms)
    load = lambda ch: -(-B * -(-d_in // ch) // sms) * ch
    assert load(p.channels) == min(load(ch) for ch in ops._SCAN_CHANNELS)
