"""The port's side of ``tests/test_torch_tp_serving.py``: a gloo world of 8
CPU ranks (``torch.multiprocessing.spawn``, one thread each, a ``file://``
rendezvous of its own) that runs every tensor-parallel serving scenario on
the port and pickles what rank 0 records.

    python tests/_torch_tp_worker.py REF_PICKLE OUT_PICKLE \
        [families|encdec|fabric]

REF_PICKLE is the reference run's output (its prompts and initial
parameters); this file imports no JAX.  With ``families`` it runs the
scenarios of ``tests/test_torch_tp_families.py`` (the SSM, hybrid and
MoE/MLA decoders), with ``encdec`` those of
``tests/test_torch_tp_encdec.py`` (the encoder and enc-dec engines), with
``fabric`` those of ``tests/test_torch_tp_fabric.py`` (the policy-driven
fabric: the policy and Stage 1, EOS, preemption, replica groups and the
background prewarm on the mesh), else those of
``tests/test_torch_tp_serving.py``.
Every rank runs every scenario in the same order, as the engines'
collectives require; a scenario that hangs fails at the gloo timeout.
"""
import contextlib
import dataclasses
import datetime
import io
import os
import pickle
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
WORLD = 8
SERVE = dict(max_slots=2, max_len=64, eos_id=-1)


def _cfg(arch, dtype="float32"):
    from repro_torch.configs import get_reduced

    return dataclasses.replace(get_reduced(arch), dtype=dtype)


def _params(ref, key, cfg):
    from repro_torch.bridge import params_from_jax

    return params_from_jax(ref[key], cfg, "cpu")


def _serve(engine, prompts, script=None, comp=None, new=10, on_step=None):
    """Submit ``prompts``, step to the end (``script``: step -> CU ids to
    reshard onto), and return the results."""
    for p in prompts:
        engine.submit(p, max_new_tokens=new)
    step = 0
    while engine.has_work:
        if script and step in script:
            engine.reshard_to(comp.submesh(script[step], "re"))
        if on_step is not None:
            on_step(step, engine)
        engine.step()
        step += 1
        assert step < 200
    return engine.results()


def _local(full, model, rules, shard):
    """This rank's shards of a whole param tree."""
    from repro_torch.distribution import partitioning as part

    plan = part.ShardingPlan.of(full, model.logical_specs())
    dims = plan.model_dims(rules, shard.size)
    return plan.unflatten([shard.local(t, d)
                           for t, d in zip(plan.leaves(full), dims)])


def _first_logits(model, params, prompts, tp=None, rules=None):
    """Prefill logits of the padded prompts and the logits of the decode
    step after them, whole (gathered over the model group)."""
    from repro_torch.distribution import partitioning as part

    B, S = len(prompts), 16
    toks = torch.zeros((B, S), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p)
    lens = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32)
    cache = model.init_cache(B, 64)
    if tp is not None:
        plan = part.ShardingPlan.of(cache, model.cache_logical_specs(B, 64))
        dims = plan.model_dims(rules, tp.size)
        cache = plan.unflatten([tp.local(t, d)
                                for t, d in zip(plan.leaves(cache), dims)])
    logits, cache = model.prefill(params, {"tokens": toks}, cache,
                                  true_len=lens, use_kernels=False, tp=tp)
    nxt = model.greedy(logits, tp)
    step, _ = model.decode_step(params, cache, nxt[:, None].long(),
                                use_kernels=False, tp=tp)
    return (model.gather_logits(logits, tp).float(),
            model.gather_logits(step, tp).float())


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _tp_degrees(ref, comp, out):
    """(a), (b), (e): streams at every degree and across reshards, logits,
    local shapes."""
    from repro_torch.core.dse import DesignPoint
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import DecodeEngine, ServeConfig

    rank = dist.get_rank()
    rules = part.serve_engine_rules()
    sc = ServeConfig(**SERVE)
    prompts = ref["prompts"]
    for arch in ("minitron-4b", "qwen2.5-32b", "granite-34b"):
        cfg = _cfg(arch)
        model = Model(cfg, "cpu")
        full = _params(ref, (arch, "params"), cfg)

        def engine(ids, rules_, params=full):
            return DecodeEngine(model, params, sc, mesh=comp.submesh(ids, "t"),
                                rules=rules_)

        if rank == 0:
            out[arch, "unsharded"] = _serve(DecodeEngine(model, full, sc),
                                            prompts)
        out[arch, 1] = _serve(engine(range(1), None), prompts)
        out[arch, 2] = _serve(engine(range(2), rules), prompts)
        degrees = (4, 8) if arch == "minitron-4b" else (2,)
        if arch == "minitron-4b":
            out[arch, 4] = _serve(engine(range(4), rules), prompts)
            out[arch, "dyn"] = _serve(
                engine(range(4), rules), prompts,
                {3: range(2), 7: range(8), 11: range(4)}, comp)
            meshes = []
            out["recompose"] = _serve(
                engine(range(4), rules), prompts,
                {3: range(6), 7: range(2), 11: range(8)}, comp,
                on_step=lambda s, e: meshes.append(list(e._shard.ranks))
                if s in (0, 3, 7, 11) else None)
            out["recompose_meshes"] = meshes
            for tp in (2, 4, 8):
                eng = engine(range(tp), rules)
                if eng._member:
                    lyr = eng.params["decoder"]["layers"][0]
                    shapes = {"wq": lyr["attn"]["wq"].shape[1],
                              "wk": lyr["attn"]["wk"].shape[1],
                              "w_up": lyr["ffn"]["w_up"].shape[1],
                              "embed": eng.params["embed"].shape[0],
                              "cache_k": eng.cache["scanned"]["attn"]["k"]
                              .shape[3]}
                    if rank == 0:
                        out["shapes", tp] = shapes
            # (e) a 4-column grant computing on its first two columns
            eng = engine(range(4), rules)
            applied = {}

            def narrow(step, e):
                if step == 3:
                    applied.update(e.apply(None, DesignPoint(cus=0, tp=2)))

            streams = _serve(eng, prompts, on_step=narrow)
            out["apply_tp"] = {
                "applied": applied, "ranks": list(eng._shard.ranks),
                "design_tp": eng.design()["tp"],
                "wq_heads": (eng.params["decoder"]["layers"][0]["attn"]
                             ["wq"].shape[1] if eng._member else None),
                "streams": streams}
        # first-step logits against the unsharded model
        unsharded = _first_logits(model, full, prompts) if rank == 0 \
            else None
        for tp in degrees:
            sub = comp.submesh(range(tp), "logits")
            shard = part.TPShard.of(sub.mesh)
            if shard.member:
                got = _first_logits(model, _local(full, model, rules, shard),
                                    prompts, shard, rules)
                if rank == 0:
                    out["logits", arch, tp] = {
                        "prefill": _rel(got[0], unsharded[0]),
                        "decode": _rel(got[1], unsharded[1])}


def _straddle(comp, out):
    """Query heads whose KV groups straddle ranks: 12 heads on 4 KV heads
    (groups of 3) at TP 3, 4 heads a rank, each taking one KV head per
    query head; the port's own seeded weights, unsharded as the yardstick."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(_cfg("minitron-4b"), num_heads=12,
                              num_kv_heads=4)
    model = Model(cfg, "cpu")
    full = model.init(torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=n) for n in (5, 9, 12)]
    rules = part.serve_engine_rules()
    shard = part.TPShard.of(comp.submesh(range(3), "straddle").mesh)
    if shard.member:
        got = _first_logits(model, _local(full, model, rules, shard),
                            prompts, shard, rules)
        if dist.get_rank() == 0:
            want = _first_logits(model, full, prompts)
            out["logits", "straddle", 3] = {
                "prefill": _rel(got[0], want[0]),
                "decode": _rel(got[1], want[1])}


def _bf16(ref, comp, out):
    """(c): bf16 at TP 2 against unsharded."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import DecodeEngine, ServeConfig

    rank = dist.get_rank()
    rules = part.serve_engine_rules()
    cfg = _cfg("minitron-4b", "bfloat16")
    model = Model(cfg, "cpu")
    full = _params(ref, ("minitron-4b", "params"), cfg)
    sc = ServeConfig(**SERVE)
    prompts = ref["prompts"]
    tp2 = _serve(DecodeEngine(model, full, sc,
                              mesh=comp.submesh(range(2), "t"), rules=rules),
                 prompts)
    sub = comp.submesh(range(2), "t")
    shard = part.TPShard.of(sub.mesh)
    got = None
    if shard.member:
        got = _first_logits(model, _local(full, model, rules, shard),
                            prompts, shard, rules)
    if rank != 0:
        return
    one = _serve(DecodeEngine(model, full, sc), prompts)
    want = _first_logits(model, full, prompts)
    margins = []
    for rid, stream in one.items():
        other = tp2[rid]
        if other == stream:
            continue
        at = next(i for i, (a, b) in enumerate(zip(stream, other)) if a != b)
        # the unsharded model's logits where the streams part
        toks = torch.as_tensor([list(prompts[rid]) + stream[:at]],
                               dtype=torch.int32)
        cache = model.init_cache(1, 64)
        lg, _ = model.prefill(full, {"tokens": toks}, cache,
                              use_kernels=False)
        top = torch.topk(lg[0].float(), 2).values
        margins.append(float((top[0] - top[1]) / lg[0].float().abs().max()))
    out["bf16"] = {"logits": max(_rel(got[0], want[0]),
                                 _rel(got[1], want[1])),
                   "partings": len(margins), "margins": margins}


def _fabric(ref, mesh, out):
    """(d) and (f): ComposedServer on (1, 8)."""
    from repro_torch.serve import fabric as F
    from repro_torch.workloads.decode import ServeConfig

    rank = dist.get_rank()
    cfg = _cfg("minitron-4b")
    fsc = ServeConfig(max_slots=2, max_len=32, eos_id=-1)
    params = {n: _params(ref, ("fabric", n), cfg) for n in "abc"}
    prompts = ref["prompts"][:2]
    F.get_reduced = lambda arch: cfg

    def server(names, **kw):
        return F.ComposedServer(
            [F.TenantSpec(n, "minitron-4b", seed=s, serve=fsc)
             for n, s in names], mesh=mesh, device="cpu", params=params,
            policy=None, **kw)

    def traffic(srv, recompose):
        rids = []
        for n in "abc":
            for p in prompts:
                rids.append((n, srv.submit(n, p, max_new_tokens=10)))
        for _ in range(3):
            srv.step()
        before = None
        if recompose:
            c = srv.engines["c"].replicas[0]
            before = (srv.subs["c"], list(c._shard.ranks),
                      [t.data_ptr() for t in _leaves(c.params)]
                      if c._member else [])
            srv.recompose({"a": 4, "b": 2, "c": 2})
        res = srv.drain()
        return [[n, r, list(res[n][r])] for n, r in rids], before

    names = (("a", 0), ("b", 1), ("c", 2))
    srv = server(names)
    streams, (c_sub, c_ranks, c_ptrs) = traffic(srv, True)
    c = srv.engines["c"].replicas[0]
    same = ([t.data_ptr() for t in _leaves(c.params)] == c_ptrs
            if c._member else True)
    same_everywhere = [None] * WORLD
    dist.all_gather_object(same_everywhere, same)
    base, _ = traffic(server(names), False)
    if rank == 0:
        out["fabric"] = {
            "c_same_sub": srv.subs["c"] is c_sub,
            "c_ranks": [c_ranks, list(c._shard.ranks)],
            "c_tensors_same": all(same_everywhere),
            "a_ranks": list(srv.engines["a"].replicas[0]._shard.ranks),
            "b_ranks": list(srv.engines["b"].replicas[0]._shard.ranks),
            "events": [[e.step, e.reason, e.sizes_after, e.design,
                        list(e.moved), list(e.unchanged)]
                       for e in srv.events],
            "streams": streams, "never_recomposed": base}

    # (f) warm recomposition: two tenants 4 + 4, then 6 + 2
    srv = server((("a", 0), ("b", 1)), warm=True)
    for n in "ab":
        srv.submit(n, ref["prompts"][0][:8], max_new_tokens=16)
    for _ in range(3):
        srv.step()
    ev = srv.recompose({"a": 6, "b": 2})
    builds = {n: srv.engines[n].compile_builds for n in "ab"}
    srv.step()
    after = {n: srv.engines[n].compile_builds for n in "ab"}
    srv.drain()
    if rank == 0:
        out["warm"] = {
            "warm_builds": ev.warm_builds,
            "cold_after_move": {n: after[n] - builds[n] for n in "ab"},
            "ranks": {n: len(srv.engines[n].replicas[0]._shard.ranks)
                      for n in "ab"},
            "post_step_recorded": sorted(ev.post_step_seconds)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _replicated(ref, comp, out):
    """(h): an SSM engine and an encoder engine whole on a sub-mesh, moved
    mid-stream; the encoder engine under TP rules builds and encodes."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import ServeConfig
    from repro_torch.workloads.encoder import EncoderEngine
    from repro_torch.workloads.ssm import SSMEngine

    rank = dist.get_rank()
    cfg = _cfg("falcon-mamba-7b")
    model = Model(cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    full = model.init(gen)
    sc = ServeConfig(**SERVE)
    prompts = ref["prompts"]
    moved = _serve(SSMEngine(model, full, sc,
                             mesh=comp.submesh(range(2), "s")), prompts,
                   {2: range(3, 7)}, comp, new=6)
    ecfg = _cfg("qwen2.5-32b")
    emodel = Model(ecfg, "cpu")
    efull = _params(ref, ("qwen2.5-32b", "params"), ecfg)
    ruled = EncoderEngine(emodel, efull, ServeConfig(max_slots=2,
                                                     max_len=32),
                          mesh=comp.submesh(range(2), "e"),
                          rules=part.serve_engine_rules())
    for p in prompts:
        ruled.submit(p)
    ruled.run_to_completion()
    ruled = ruled.results()
    enc = EncoderEngine(emodel, efull, ServeConfig(max_slots=2, max_len=32),
                        mesh=comp.submesh(range(2), "e"))
    for p in prompts[:2]:
        enc.submit(p)
    enc.step()
    enc.reshard_to(comp.submesh(range(4, 8), "e2"))
    enc.submit(prompts[2])
    enc.step()
    enc_moved = enc.results()
    if rank == 0:
        one = _serve(SSMEngine(model, full, sc), prompts, new=6)
        e1 = EncoderEngine(emodel, efull, ServeConfig(max_slots=2,
                                                      max_len=32))
        for p in prompts:
            e1.submit(p)
        e1.run_to_completion()
        out["replicated"] = {
            "ssm_moved": moved, "ssm_unsharded": one,
            "encoder_ruled": ruled,
            "encoder_moved": {r: np.round(v, 5).tolist()
                              for r, v in enc_moved.items()},
            "encoder_unsharded": {r: np.round(v, 5).tolist()
                                  for r, v in e1.results().items()}}


def _rows(ref, out):
    """The launcher's production-mesh serving on a (2, 4) mesh: one engine
    per data row over disjoint requests; every rank builds both and does
    device work for its own row's only."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import DecodeEngine, ServeConfig
    from torch.distributed.device_mesh import init_device_mesh

    cfg = _cfg("minitron-4b")
    model = Model(cfg, "cpu")
    full = _params(ref, ("minitron-4b", "params"), cfg)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    engines = launch_serve.row_engines(DecodeEngine, model, full,
                                       ServeConfig(**SERVE), mesh,
                                       part.serve_engine_rules())
    streams, rounds, emitted, _ = launch_serve.serve_rows(
        engines, ref["prompts"], 10)
    own = [None] * WORLD
    dist.all_gather_object(own, [i for i, e in enumerate(engines)
                                 if e._member])
    if dist.get_rank() == 0:
        one = launch_serve.serve_rows(
            [DecodeEngine(model, full, ServeConfig(**SERVE))],
            ref["prompts"], 10)
        out["rows"] = {"streams": streams, "emitted": [emitted, one[2]],
                       "rounds": rounds, "own_rows": own,
                       "ranks": [list(e._shard.ranks) for e in engines],
                       "slots": [e.cfg.max_slots for e in engines]}


def _smoke(out):
    """(g): the launcher's --tp-smoke on this world."""
    from repro_torch.launch import serve as launch_serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(["--tp-smoke", "--device", "cpu"])
    if dist.get_rank() == 0:
        out["smoke"] = (rc, buf.getvalue().splitlines()[0])


# ---------------------------------------------------------------------------
# families: tests/test_torch_tp_families.py
# ---------------------------------------------------------------------------

FAMILIES = ("falcon-mamba-7b", "hymba-1.5b", "deepseek-v2-lite-16b")


def _engine_cls(arch):
    from repro_torch.workloads.decode import DecodeEngine
    from repro_torch.workloads.ssm import SSMEngine

    return SSMEngine if arch == "falcon-mamba-7b" else DecodeEngine


def _exact_logits(model, params, prompts, tp=None, rules=None):
    """Prefill logits of the prompts cut to their shortest length (no
    padding: an SSM prefill folds every position into its state) and the
    logits of the decode step after them, whole."""
    from repro_torch.distribution import partitioning as part

    S = min(len(p) for p in prompts)
    toks = torch.as_tensor(np.stack([p[:S] for p in prompts]),
                           dtype=torch.int32)
    B = len(prompts)
    cache = model.init_cache(B, 64)
    if tp is not None:
        plan = part.ShardingPlan.of(cache, model.cache_logical_specs(B, 64))
        dims = plan.model_dims(rules, tp.size)
        cache = plan.unflatten([tp.local(t, d)
                                for t, d in zip(plan.leaves(cache), dims)])
    logits, cache = model.prefill(params, {"tokens": toks}, cache,
                                  use_kernels=False, tp=tp)
    nxt = model.greedy(logits, tp)
    step, _ = model.decode_step(params, cache, nxt[:, None].long(),
                                use_kernels=False, tp=tp)
    return (model.gather_logits(logits, tp).float(),
            model.gather_logits(step, tp).float())


def _flat_shapes(tree, path=()):
    """{path: shape} of a tree of tensors (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat_shapes(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat_shapes(t, path + (i,)).items()}
    return {path: tuple(tree.shape)}


def _in_proj_is_xz(eng, full, shard):
    """Every layer's local ``in_proj`` is the x and then the z columns of
    this rank's channels of the whole one."""
    ok = True
    for mine, whole in zip(eng.params["decoder"]["layers"],
                           full["decoder"]["layers"]):
        w = whole["ssm"]["in_proj"]
        d_in = w.shape[1] // 2
        n = d_in // shard.size
        lo = shard.index * n
        want = torch.cat([w[:, lo:lo + n], w[:, d_in + lo:d_in + lo + n]], 1)
        ok = ok and torch.equal(mine["ssm"]["in_proj"], want)
    return ok


def _families_tp(ref, comp, out):
    """(a)-(c): streams at every degree and across the reshard script,
    first-step logits, local shapes and the in_proj layout."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import ServeConfig

    rank = dist.get_rank()
    rules = part.serve_engine_rules()
    sc = ServeConfig(**SERVE)
    prompts = ref["prompts"]
    for arch in FAMILIES:
        cfg = _cfg(arch)
        model = Model(cfg, "cpu")
        full = _params(ref, (arch, "params"), cfg)
        cls = _engine_cls(arch)

        def engine(tp, rules_):
            return cls(model, full, sc, mesh=comp.submesh(range(tp), "t"),
                       rules=rules_)

        if rank == 0:
            out[arch, "unsharded"] = _serve(cls(model, full, sc), prompts)
        out[arch, 1] = _serve(engine(1, None), prompts)
        for tp in (2, 4, 8):
            eng = engine(tp, rules)
            xz = _in_proj_is_xz(eng, full, eng._shard) \
                if cfg.ssm is not None and eng._member else True
            every = [None] * WORLD
            dist.all_gather_object(every, xz)
            if rank == 0:
                out["shapes", arch, tp] = {
                    "params": _flat_shapes(eng.params),
                    "cache": _flat_shapes(eng.cache),
                    "n_scanned": len(eng.params["decoder"]["layers"]),
                    "in_proj_xz": all(every)}
                if tp == 2 and cfg.ssm is not None:
                    mine = eng.params["decoder"]["layers"][0]["ssm"][
                        "in_proj"]
                    whole = full["decoder"]["layers"][0]["ssm"]["in_proj"]
                    contiguous = whole[:, :whole.shape[1] // 2]
                    out["in_proj_tp2"] = {
                        "shape_equal": mine.shape == contiguous.shape,
                        "content_equal_contiguous": torch.equal(
                            mine, contiguous)}
            out[arch, tp] = _serve(eng, prompts)
        out[arch, "dyn"] = _serve(engine(2, rules), prompts,
                                  {3: range(1), 7: range(4), 11: range(2)},
                                  comp)
        unsharded = _exact_logits(model, full, prompts) if rank == 0 \
            else None
        for tp in (2, 4, 8):
            shard = part.TPShard.of(comp.submesh(range(tp), "logits").mesh)
            if shard.member:
                got = _exact_logits(model, _local(full, model, rules, shard),
                                    prompts, shard, rules)
                if rank == 0:
                    out["logits", arch, tp] = {
                        "prefill": _rel(got[0], unsharded[0]),
                        "decode": _rel(got[1], unsharded[1])}


def _families_bf16(ref, comp, out):
    """(d): bf16 at TP 2 against unsharded, per family."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import ServeConfig

    rank = dist.get_rank()
    rules = part.serve_engine_rules()
    sc = ServeConfig(**SERVE)
    prompts = ref["prompts"]
    for arch in FAMILIES:
        cfg = _cfg(arch, "bfloat16")
        model = Model(cfg, "cpu")
        full = _params(ref, (arch, "params"), cfg)
        cls = _engine_cls(arch)
        sub = comp.submesh(range(2), "t")
        tp2 = _serve(cls(model, full, sc, mesh=sub, rules=rules), prompts)
        shard = part.TPShard.of(sub.mesh)
        got = None
        if shard.member:
            got = _exact_logits(model, _local(full, model, rules, shard),
                                prompts, shard, rules)
        if rank != 0:
            continue
        one = _serve(cls(model, full, sc), prompts)
        want = _exact_logits(model, full, prompts)
        margins = []
        for rid, stream in one.items():
            other = tp2[rid]
            if other == stream:
                continue
            at = next(i for i, (a, b) in enumerate(zip(stream, other))
                      if a != b)
            toks = torch.as_tensor([list(prompts[rid]) + stream[:at]],
                                   dtype=torch.int32)
            lg, _ = model.prefill(full, {"tokens": toks},
                                  model.init_cache(1, 64), use_kernels=False)
            top = torch.topk(lg[0].float(), 2).values
            margins.append(float((top[0] - top[1])
                                 / lg[0].float().abs().max()))
        out["bf16", arch] = {"logits": max(_rel(got[0], want[0]),
                                           _rel(got[1], want[1])),
                             "partings": len(margins), "margins": margins}


def _families_fabric(ref, mesh, out):
    """(e): an SSM and a hybrid tenant on ComposedServer(mesh, tp=True),
    4 + 4 columns recomposed to 6 + 2 mid-stream."""
    from repro_torch.serve import fabric as F
    from repro_torch.workloads.decode import ServeConfig

    fsc = ServeConfig(max_slots=2, max_len=32, eos_id=-1)
    archs = {"s": "falcon-mamba-7b", "h": "hymba-1.5b"}
    params = {n: _params(ref, ("fabric", n), _cfg(a))
              for n, a in archs.items()}
    F.get_reduced = lambda arch: _cfg(arch)
    srv = F.ComposedServer(
        [F.TenantSpec("s", archs["s"], seed=0, serve=fsc),
         F.TenantSpec("h", archs["h"], seed=1, serve=fsc)], mesh=mesh,
        device="cpu", params=params, policy=None)
    size = lambda n: len(srv.engines[n].replicas[0]._shard.ranks)
    before = {n: size(n) for n in "sh"}
    rids = []
    for n in "sh":
        for p in ref["prompts"][:2]:
            rids.append((n, srv.submit(n, p, max_new_tokens=10)))
    for _ in range(3):
        srv.step()
    srv.recompose({"s": 6, "h": 2})
    res = srv.drain()
    if dist.get_rank() == 0:
        out["fabric"] = {
            "ranks_before": before, "ranks_after": {n: size(n) for n in "sh"},
            "ruled": {n: srv.engines[n].replicas[0].rules is not None
                      for n in "sh"},
            "events": [[e.step, e.reason, e.sizes_after, e.design,
                        list(e.moved), list(e.unchanged)]
                       for e in srv.events],
            "streams": [[n, r, list(res[n][r])] for n, r in rids]}


def _families_admitted(comp, out):
    """(f): every arch's engine of its own class, and an encoder engine of
    every arch, under serve_engine_rules() on two ranks; each encoder
    engine encodes one job."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.base import build_engine, workload_class_of
    from repro_torch.workloads.decode import ServeConfig
    from repro_torch.workloads.encoder import EncoderEngine

    rules = part.serve_engine_rules()
    sc = ServeConfig(**SERVE)
    built, encoded, raised = {}, {}, {}
    for arch in ARCH_IDS:
        cfg = _cfg(arch)
        model = Model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        sub = comp.submesh(range(2), "admit")
        try:
            eng = build_engine(workload_class_of(cfg), model, params, sc,
                               mesh=sub, rules=rules)
            built[arch] = type(eng).__name__
            enc = EncoderEngine(model, params, sc, mesh=sub, rules=rules)
            enc.submit(np.arange(1, 9))
            enc.step()
            emb = enc.results()[0]
            encoded[arch] = len(emb) == cfg.d_model and bool(
                np.isfinite(emb).all())
        except ValueError as e:
            raised[arch] = str(e)
    if dist.get_rank() == 0:
        out["admitted"] = {"built": built, "encoded": encoded,
                           "raised": raised}


def _run_families(ref, comp, mesh, out):
    _families_tp(ref, comp, out)
    _families_bf16(ref, comp, out)
    _families_fabric(ref, mesh, out)
    _families_admitted(comp, out)


# ---------------------------------------------------------------------------
# encoder and enc-dec: tests/test_torch_tp_encdec.py
# ---------------------------------------------------------------------------

SEAMLESS, QWEN = "seamless-m4t-medium", "qwen2.5-32b"
ENCDEC_SERVE = dict(max_slots=2, max_len=24, eos_id=-1, max_src_len=16,
                    len_buckets=(8,))
ENCODER_SERVE = dict(max_slots=2, max_len=32)
ENCDEC_NEW = 8


def _sources(srcs, S=16):
    """(B, S) right-padded int32 sources and their (B,) lengths."""
    toks = torch.zeros((len(srcs), S), dtype=torch.int32)
    for i, src in enumerate(srcs):
        toks[i, :len(src)] = torch.as_tensor(src)
    return toks, torch.as_tensor([len(x) for x in srcs], dtype=torch.int32)


def _encdec_logits(model, params, srcs, tp=None, rules=None, prefix=None):
    """The logits of the [bos] (+ ``prefix``) prefill over the batched
    encode of ``srcs`` and of the decode step after it, whole."""
    from repro_torch.distribution import partitioning as part

    toks, lens = _sources(srcs)
    B, S = toks.shape
    enc = model.encode(params, {"tokens": toks}, lens=lens,
                       use_kernels=False, tp=tp)
    dec = torch.tensor([[1] + list(prefix or [])] * B, dtype=torch.int32)
    cache = model.init_cache(B, 24, src_len=S)
    if tp is not None:
        plan = part.ShardingPlan.of(
            cache, model.cache_logical_specs(B, 24, src_len=S))
        dims = plan.model_dims(rules, tp.size)
        cache = plan.unflatten([tp.local(t, d)
                                for t, d in zip(plan.leaves(cache), dims)])
    logits, cache = model.prefill(params, {"tokens": dec}, cache,
                                  use_kernels=False, enc_out=enc,
                                  src_len=lens, tp=tp)
    nxt = model.greedy(logits, tp)
    step, _ = model.decode_step(params, cache, nxt[:, None].long(),
                                use_kernels=False, tp=tp)
    return (model.gather_logits(logits, tp).float(),
            model.gather_logits(step, tp).float())


def _encdec_tp(ref, comp, out):
    """seamless-reduced through EncDecEngine: streams at TP 1, 2, 4 and
    across the reshard script, local shapes, first-step logits, and the
    tokens-as-frames encode."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import ServeConfig
    from repro_torch.workloads.encdec import EncDecEngine

    rank = dist.get_rank()
    rules = part.serve_engine_rules()
    sc = ServeConfig(**ENCDEC_SERVE)
    cfg = _cfg(SEAMLESS)
    model = Model(cfg, "cpu")
    full = _params(ref, (SEAMLESS, "params"), cfg)
    srcs = ref["srcs"]
    if rank == 0:
        out[SEAMLESS, "unsharded"] = _serve(EncDecEngine(model, full, sc),
                                            srcs, new=ENCDEC_NEW)
    for tp in (1, 2, 4):
        eng = EncDecEngine(model, full, sc,
                           mesh=comp.submesh(range(tp), "t"), rules=rules)
        if rank == 0 and tp > 1:
            out["shapes", tp] = {
                "params": _flat_shapes(eng.params),
                "cache": _flat_shapes(eng.cache),
                "n_layers": (len(eng.params["encoder"]["layers"]),
                             len(eng.params["decoder"]["layers"]))}
        out[SEAMLESS, tp] = _serve(eng, srcs, new=ENCDEC_NEW)
    out[SEAMLESS, "dyn"] = _serve(
        EncDecEngine(model, full, sc, mesh=comp.submesh(range(2), "t"),
                     rules=rules),
        srcs, {3: range(1), 7: range(4)}, comp, new=ENCDEC_NEW)
    want = _encdec_logits(model, full, srcs) if rank == 0 else None
    for tp in (2, 4):
        shard = part.TPShard.of(comp.submesh(range(tp), "logits").mesh)
        if shard.member:
            got = _encdec_logits(model, _local(full, model, rules, shard),
                                 srcs, shard, rules)
            if rank == 0:
                out["logits", tp] = {"prefill": _rel(got[0], want[0]),
                                     "decode": _rel(got[1], want[1])}
    # token ids as stand-in frames: the vocab-split table's lookup
    shard = part.TPShard.of(comp.submesh(range(2), "frames").mesh)
    toks, lens = _sources(srcs)
    toks[:, 0] = torch.tensor([3, 130, 200, 255])   # ids in both halves
    if shard.member:
        local = _local(full, model, rules, shard)
        rows = local["embed"].shape[0]
        frames = model._embed(local, toks, shard)
        got = model.encode(local, {"tokens": toks}, lens=lens,
                           use_kernels=False, tp=shard)
        whole = model.encode(full, {"tokens": toks}, lens=lens,
                             use_kernels=False)
        mask = (torch.arange(toks.shape[1])[None, :] < lens[:, None])
        every = [None] * 2
        dist.all_gather_object(every, {
            "rows": rows,
            "lookup_exact": torch.equal(frames, full["embed"][toks.long()]),
            # what indexing the local table directly would have given
            "direct_rows_right": torch.equal(
                local["embed"][toks.long() % rows],
                full["embed"][toks.long()]),
            "encode": _rel(got[mask], whole[mask])},
            group=shard.group)
        if rank == 0:
            out["frames"] = every


def _encoder_tp(ref, comp, out):
    """qwen2.5-reduced through EncoderEngine at TP 2 (moved to two other
    ranks mid-stream too), and falcon-mamba- and deepseek-v2-lite-reduced
    at TP 2 on the port's own seeded weights, each beside its unsharded
    engine."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import ServeConfig
    from repro_torch.workloads.encoder import EncoderEngine

    rank = dist.get_rank()
    rules = part.serve_engine_rules()
    sc = ServeConfig(**ENCODER_SERVE)
    jobs = ref["jobs"]

    def run(model, params, ids, rules_, move=None):
        eng = (EncoderEngine(model, params, sc) if ids is None else
               EncoderEngine(model, params, sc, mesh=comp.submesh(ids, "e"),
                             rules=rules_))
        for i, job in enumerate(jobs):
            eng.submit(job)
            if move is not None and i == 2:
                eng.reshard_to(comp.submesh(move, "moved"))
            eng.step()
        return eng.results()

    for arch in (QWEN, "falcon-mamba-7b", "deepseek-v2-lite-16b"):
        cfg = _cfg(arch)
        model = Model(cfg, "cpu")
        full = (_params(ref, (QWEN, "params"), cfg) if arch == QWEN
                else model.init(torch.Generator().manual_seed(0)))
        got = {"tp2": run(model, full, range(2), rules)}
        if arch == QWEN:
            got["moved"] = run(model, full, range(2), rules, move=[4, 5])
        if rank == 0:
            got["unsharded"] = run(model, full, None, None)
            out[arch, "encoder"] = got


def _encdec_bf16(ref, comp, out):
    """bf16 seamless at TP 2 against unsharded: logits and stream
    partings with their top-2 margins."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import ServeConfig
    from repro_torch.workloads.encdec import EncDecEngine

    rank = dist.get_rank()
    rules = part.serve_engine_rules()
    cfg = _cfg(SEAMLESS, "bfloat16")
    model = Model(cfg, "cpu")
    full = _params(ref, (SEAMLESS, "params"), cfg)
    sc = ServeConfig(**ENCDEC_SERVE)
    srcs = ref["srcs"]
    sub = comp.submesh(range(2), "t")
    tp2 = _serve(EncDecEngine(model, full, sc, mesh=sub, rules=rules), srcs,
                 new=ENCDEC_NEW)
    shard = part.TPShard.of(sub.mesh)
    got = None
    if shard.member:
        got = _encdec_logits(model, _local(full, model, rules, shard), srcs,
                             shard, rules)
    if rank != 0:
        return
    one = _serve(EncDecEngine(model, full, sc), srcs, new=ENCDEC_NEW)
    want = _encdec_logits(model, full, srcs)
    margins = []
    for rid, stream in one.items():
        other = tp2[rid]
        if other == stream:
            continue
        at = next(i for i, (a, b) in enumerate(zip(stream, other)) if a != b)
        # the unsharded model's logits where the streams part
        lg = _encdec_logits(model, full, [srcs[rid]], prefix=stream[:at])[0]
        top = torch.topk(lg[0], 2).values
        margins.append(float((top[0] - top[1]) / lg[0].abs().max()))
    out["bf16"] = {"logits": max(_rel(got[0], want[0]),
                                 _rel(got[1], want[1])),
                   "partings": len(margins), "margins": margins}


def _encdec_fabric(ref, mesh, out):
    """An encoder tenant (qwen2.5-reduced) and an enc-dec tenant
    (seamless-reduced) on ComposedServer(mesh, tp=True), 4 + 4 columns
    recomposed to 2 + 6 mid-stream."""
    from repro_torch.serve import fabric as F
    from repro_torch.workloads.decode import ServeConfig

    archs = {"e": QWEN, "d": SEAMLESS}
    fsc = {"e": ServeConfig(max_slots=2, max_len=32, eos_id=-1),
           "d": ServeConfig(**ENCDEC_SERVE)}
    params = {n: _params(ref, ("fabric", n), _cfg(a))
              for n, a in archs.items()}
    F.get_reduced = lambda arch: _cfg(arch)
    srv = F.ComposedServer(
        [F.TenantSpec("e", QWEN, seed=0, serve=fsc["e"], workload="encoder"),
         F.TenantSpec("d", SEAMLESS, seed=1, serve=fsc["d"])], mesh=mesh,
        device="cpu", params=params, policy=None)
    size = lambda n: len(srv.engines[n].replicas[0]._shard.ranks)
    before = {n: size(n) for n in "ed"}
    rids = []
    for job in ref["jobs"][:3]:
        rids.append(("e", srv.submit("e", job)))
    for src in ref["srcs"][:3]:
        rids.append(("d", srv.submit("d", src, max_new_tokens=ENCDEC_NEW)))
    for _ in range(3):
        srv.step()
    srv.recompose({"e": 2, "d": 6})
    res = srv.drain()
    if dist.get_rank() == 0:
        out["fabric"] = {
            "ranks_before": before, "ranks_after": {n: size(n) for n in "ed"},
            "ruled": {n: srv.engines[n].replicas[0].rules is not None
                      for n in "ed"},
            "events": [[e.step, e.reason, e.sizes_after, e.design,
                        list(e.moved), list(e.unchanged)]
                       for e in srv.events],
            "streams": [[n, r, list(res[n][r])] for n, r in rids]}


def _run_encdec(ref, comp, mesh, out):
    _encdec_tp(ref, comp, out)
    _encoder_tp(ref, comp, out)
    _encdec_bf16(ref, comp, out)
    _encdec_fabric(ref, mesh, out)


# ---------------------------------------------------------------------------
# the policy-driven fabric on a mesh: tests/test_torch_tp_fabric.py
# ---------------------------------------------------------------------------

def _tpu_numbers():
    """The reference's per-chip TPU_V5E numbers, as one CU of the port's
    policy (tests/test_torch_fabric_policy.py holds them to the
    reference's record)."""
    from repro_torch.common.platform import PlatformProfile

    return PlatformProfile(
        name="tpu_v5e", peak_flops=197e12, atom_shape=(8, 128, 128),
        atom_cycles=8.0, compute_clock_hz=0.94e9, num_compute_units=4,
        hbm_bytes=16 << 30, hbm_bw=819e9, onchip_bytes=128 << 20,
        onchip_bw=22e12, ici_bw=50e9, ici_links=4, instr_bytes=32,
        reconfig_cycles=16.0, bitstream_reload_s=10.0)


def _fleet_server(ref, mesh, specs, **kw):
    """ComposedServer on ``mesh`` over ``specs`` ((name, arch, seed,
    serve config[, spec keywords])), on the reference's initial params."""
    from repro_torch.serve import fabric as F

    F.get_reduced = lambda arch: _cfg(arch)
    tenants, params = [], {}
    for name, arch, seed, sc, *extra in specs:
        tenants.append(F.TenantSpec(name, arch, seed=seed, serve=sc,
                                    **(extra[0] if extra else {})))
        params[name] = _params(ref["params"], (arch, seed), _cfg(arch))
    return F.ComposedServer(tenants, mesh=mesh, device="cpu", params=params,
                            **kw)


def _fabric_serve(srv, traffic, script=None, before_step=None,
                  max_steps=500):
    """The reference script's ``serve``: submit ``traffic`` at step 0, step
    to the end (``script``: step -> call), return events and streams, with
    every step's SLO preemptions."""
    rids = [(t, srv.submit(t, p, max_new_tokens=n)) for t, p, n in traffic]
    step, slo = 0, []
    while any(e.has_work for e in srv.engines.values()):
        if script and step in script:
            script[step](srv)
        if before_step is not None:
            before_step(srv, step)
        n0 = srv._slo_preemptions
        srv.step()
        slo.append(srv._slo_preemptions - n0)
        step += 1
        assert step < max_steps
    res = srv.results()
    return {"events": [[e.step, e.reason, e.sizes_after, e.design]
                       for e in srv.events],
            "overlapped": [e.overlapped for e in srv.events],
            "streams": [[t, r, list(map(int, res[t][r]))] for t, r in rids],
            "slo_per_step": slo}


def _everywhere(value):
    """``value`` of every rank, in rank order."""
    got = [None] * WORLD
    dist.all_gather_object(got, value)
    return got


def _replay(ref, specs, traffic, events):
    """The port's unsharded replay of a fabric run: one mesh-less
    DecodeEngine per tenant on the same params and requests, stepped
    while its tenant held CUs, its slots retuned at the recorded events'
    steps (dp and TP knobs change no token)."""
    from repro_torch.core.dse import DesignPoint
    from repro_torch.models.model import Model
    from repro_torch.workloads.decode import DecodeEngine

    engines = {name: DecodeEngine(Model(_cfg(arch), "cpu"),
                                  _params(ref["params"], (arch, seed),
                                          _cfg(arch)), sc)
               for name, arch, seed, sc, *_ in specs}
    rids = [(t, engines[t].submit(p, max_new_tokens=n))
            for t, p, n in traffic]
    base, extra = divmod(WORLD, len(specs))
    sizes = {s[0]: base + (1 if i < extra else 0)
             for i, s in enumerate(specs)}
    step = 0
    while any(e.has_work for e in engines.values()):
        for t, eng in engines.items():
            if sizes.get(t, 0) > 0:
                eng.step()
        step += 1
        for ev_step, _, after, design in events:
            if ev_step != step:
                continue
            sizes = dict(after)
            for t, knobs in design.items():
                if "slots" in knobs:
                    engines[t].apply(None, DesignPoint(cus=0,
                                                       slots=knobs["slots"]))
        assert step < 500
    res = {t: e.results() for t, e in engines.items()}
    return [[t, r, list(map(int, res[t][r]))] for t, r in rids]


def _tpf_policy(ref, mesh, out):
    """1 and 6: the reference's autoscale scenario (two minitron tenants,
    decide_every 4) under the policy on the reference's platform numbers,
    synchronous and with the background prewarm."""
    from repro_torch.serve import fabric as F
    from repro_torch.workloads.decode import ServeConfig

    sc = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
    specs = [("a", "minitron-4b", 0, sc), ("b", "minitron-4b", 1, sc)]
    traffic = ref["autoscale_traffic"]
    runs = {}
    for name, kw, hook in (
            ("sync", {}, None),
            ("async", {"prewarm_async": True}, _settle_prewarm)):
        srv = _fleet_server(ref, mesh, specs,
                            policy=F.AnalyticalPolicy(_tpu_numbers()),
                            decide_every=4, **kw)
        got = _fabric_serve(srv, traffic, before_step=hook)
        got["ranks"] = _everywhere([got["events"], got["streams"]])
        got["platform"] = srv.policy.platform.name
        got["broadcasts"] = srv.stats()["mesh_decisions"]["broadcasts"]
        runs[name] = got
    replay = _replay(ref, specs, traffic, runs["sync"]["events"])
    if dist.get_rank() == 0:
        out["policy"] = runs
        out["policy_replay"] = replay


def _settle_prewarm(srv, step):
    """A test hook: every rank waits for its own background warm-up before
    stepping, so the first rank finds it ready at the next decide tick
    and the commit's step does not depend on the threads' speed."""
    del step
    if srv._pending_prewarm is not None:
        for f in srv._pending_prewarm[2]:
            f.result()


def _tpf_dse(ref, mesh, out):
    """2: the reference's Stage 1 scenario (minitron slot_cap 4 and
    qwen2.5, decide_every 3) on the mesh."""
    from repro_torch.serve import fabric as F
    from repro_torch.workloads.decode import ServeConfig

    sc = ServeConfig(max_slots=2, max_len=48, eos_id=-1)
    specs = [("a", "minitron-4b", 0, dataclasses.replace(sc, slot_cap=4)),
             ("b", "qwen2.5-32b", 1, sc)]
    srv = _fleet_server(ref, mesh, specs,
                        policy=F.AnalyticalPolicy(_tpu_numbers()),
                        decide_every=3)
    seen = []
    best = srv.policy.stage1.best

    def spy(cfg, space, *a, **kw):
        seen.append(space.tp_allowed)
        return best(cfg, space, *a, **kw)

    srv.policy.stage1.best = spy
    got = _fabric_serve(srv, ref["dse_traffic"])
    st = srv.stats()
    pvm = st["predicted_vs_measured"]
    committed = {k: e for k, e in pvm["entries"].items()
                 if e["commits"] > 0 and e["ratio"] is not None}
    got.update(
        recompositions=st["recompositions"],
        committed={k: e["ratio"] for k, e in committed.items()},
        tp_allowed=sorted({x for xs in _everywhere(sorted(set(seen)))
                           for x in xs}),
        ranks=_everywhere(got["events"]))
    if dist.get_rank() == 0:
        out["dse"] = got


def _tpf_eos(ref, comp, mesh, out):
    """3: EOS termination on a TP-4 sub-mesh and on a (1, 8) fabric."""
    from repro_torch.distribution import partitioning as part
    from repro_torch.models.model import Model
    from repro_torch.serve import fabric as F
    from repro_torch.workloads.decode import DecodeEngine, ServeConfig

    cfg = _cfg("minitron-4b")
    model = Model(cfg, "cpu")
    params = _params(ref["params"], ("minitron-4b", 0), cfg)
    prompts = ref["eos_prompts"]

    def engine(eos, mesh_=True):
        sc = ServeConfig(max_slots=2, max_len=64, eos_id=eos)
        eng = (DecodeEngine(model, params, sc,
                            mesh=comp.submesh(range(4), "eos"),
                            rules=part.serve_engine_rules())
               if mesh_ else DecodeEngine(model, params, sc))
        for p in prompts:
            eng.submit(p, max_new_tokens=10)
        while eng.has_work:
            eng.step()
        return eng

    free = engine(-1).results()
    eos = int(free[0][4])
    eng = engine(eos)
    raw = {r: list(t) for r, t in eng._finished.items()}
    got = {"id": eos, "engine": eng.results(), "raw": _everywhere(raw)}
    if dist.get_rank() == 0:
        got["unsharded"] = engine(eos, False).results()
    sc = ServeConfig(max_slots=2, max_len=64, eos_id=eos)
    srv = _fleet_server(ref, mesh, [("a", "minitron-4b", 0, sc),
                                    ("b", "minitron-4b", 1, sc)],
                        policy=None)
    got["fabric"] = _fabric_serve(srv, [(t, p, 10) for t in "ab"
                                        for p in prompts])
    got["fabric_raw"] = _everywhere(
        {t: {r: list(x) for r, x in
             srv.engines[t].replicas[0]._finished.items()} for t in "ab"})
    if dist.get_rank() == 0:
        out["eos"] = got


def _chaos(ref, mesh, chaos_seed):
    """The reference's chaos body (tests/test_preempt_chaos.py) on the
    mesh: the reduced mixed fleet on the plain path, preempt and
    recompose at random."""
    from repro_torch.launch.serve import _streams_digest
    from repro_torch.workloads.decode import ServeConfig

    serve = ServeConfig(max_slots=2, max_len=48, eos_id=-1, kv_page_rows=8,
                        use_kernels=False)
    specs = [(n, a, i, serve, {"workload": w, "reduced": True})
             for n, a, i, w in ref["fleet"]]
    server = _fleet_server(ref, mesh, specs, policy=None, warm=False)
    for t, p, n in ref["chaos_traffic"]:
        server.submit(t, p, max_new_tokens=n)
    crng = (np.random.default_rng(chaos_seed)
            if chaos_seed is not None else None)
    names = sorted(server.engines)
    steps = 0
    while any(e.has_work for e in server.engines.values()):
        if crng is not None and steps % 2 == 1:
            op = int(crng.integers(0, 3))
            if op == 0:
                t = names[int(crng.integers(0, len(names)))]
                server.engines[t].preempt_one()
            elif op == 1:
                sizes = server.sizes()
                i, j = crng.choice(len(names), size=2, replace=False)
                a, b = names[int(i)], names[int(j)]
                if sizes.get(a, 0) > 1 and sizes.get(b, 0) > 0:
                    sizes[a] -= 1
                    sizes[b] += 1
                    server.recompose(sizes, reason="chaos")
        server.step()
        steps += 1
        assert steps < 3000, "chaos run did not drain"
    server.drain(max_steps=300)
    stats = server.stats()
    return (_streams_digest(server.results()),
            sum(stats["preemptions"].values()), stats["recompositions"])


def _tpf_chaos(ref, mesh, out):
    """4: the chaos body at seeds 3 and 11 against the run without."""
    got = {seed: _chaos(ref, mesh, seed) for seed in (None, 3, 11)}
    got["ranks"] = _everywhere([got[s][0] for s in (None, 3, 11)])
    if dist.get_rank() == 0:
        out["chaos"] = got


def _tpf_dp(ref, mesh, out):
    """5: tenant a (dp_cap 2) on its 4-column grant to dp 2 mid-stream,
    then back to 1."""
    from repro_torch.core.dse import DesignPoint
    from repro_torch.workloads.decode import ServeConfig

    sc = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
    specs = [("a", "minitron-4b", 0, sc, {"dp_cap": 2}),
             ("b", "minitron-4b", 1, sc)]
    tiles = []

    def to(dp):
        def go(srv):
            srv.recompose({"a": DesignPoint(cus=4, dp=dp), "b": 4})
            tiles.append([list(e._shard.ranks)
                          for e in srv.engines["a"].replicas])
        return go

    got = _fabric_serve(_fleet_server(ref, mesh, specs, policy=None),
                        ref["dp_traffic"], {3: to(2), 8: to(1)})
    got["tiles"] = tiles
    got["dp1"] = _fabric_serve(_fleet_server(ref, mesh, specs, policy=None),
                               ref["dp_traffic"])["streams"]
    if dist.get_rank() == 0:
        out["dp"] = got


def _tpf_divergent(ref, mesh, out):
    """7: one rank observes a per-token p99 over target where the others
    do not (a test hook on that rank's ``_refresh_slo_observed``); every
    rank applies the first rank's decision."""
    from repro_torch.serve import fabric as F
    from repro_torch.workloads.decode import ServeConfig

    sc = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
    # a target no CPU step breaches: only the hook's observation does
    slo = F.SLOTarget(per_token_p99_ms=1e6)
    specs = [("a", "minitron-4b", 0, sc, {"slo": slo}),
             ("b", "minitron-4b", 1, sc)]
    traffic = [("a", p, 12) for _, p, _ in ref["dp_traffic"][:4]]
    runs = {}
    for hooked in (None, 3, 0):
        srv = _fleet_server(ref, mesh, specs, policy=None, decide_every=2)
        if dist.get_rank() == hooked:
            refresh = srv._refresh_slo_observed

            def breach(srv=srv, refresh=refresh):
                refresh()
                srv._slo_obs[("a", "per_token_p99_ms")] = 1e9

            srv._refresh_slo_observed = breach
        got = _fabric_serve(srv, traffic)
        got["ranks"] = _everywhere([got["slo_per_step"], got["events"],
                                    srv.stats()["preemptions"]])
        got["broadcasts"] = srv.stats()["mesh_decisions"]["broadcasts"]
        runs[str(hooked)] = got
    if dist.get_rank() == 0:
        out["divergent"] = runs


def _run_fabric(ref, comp, mesh, out):
    _tpf_policy(ref, mesh, out)
    _tpf_dse(ref, mesh, out)
    _tpf_eos(ref, comp, mesh, out)
    _tpf_chaos(ref, mesh, out)
    _tpf_dp(ref, mesh, out)
    _tpf_divergent(ref, mesh, out)


def _run(rank, init, ref_path, out_path, mode=""):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.composer import MeshComposer

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = {}
    mesh = init_device_mesh("cpu", (1, WORLD),
                            mesh_dim_names=("data", "model"))
    comp = MeshComposer(mesh)
    if mode == "families":
        _run_families(ref, comp, mesh, out)
    elif mode == "encdec":
        _run_encdec(ref, comp, mesh, out)
    elif mode == "fabric":
        _run_fabric(ref, comp, mesh, out)
    else:
        _tp_degrees(ref, comp, out)
        _straddle(comp, out)
        _bf16(ref, comp, out)
        _fabric(ref, mesh, out)
        _replicated(ref, comp, out)
        _rows(ref, out)
        _smoke(out)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    rendezvous = "file://" + os.path.join(tempfile.mkdtemp(), "rdzv")
    mp.spawn(_run, args=(rendezvous, sys.argv[1], sys.argv[2],
                         sys.argv[3] if len(sys.argv) > 3 else ""),
             nprocs=WORLD)
