"""Real-time recomposition (FILCO §1/§2.1) on one card: several tenants
served by one composed card, recomposed live as traffic shifts — the
port's counterpart of the reference's ``examples/multi_tenant_serve.py``.

The scenario (8 logical CUs of one card, ``ComposedServer``):

  phase 1 — tenants A and B each hold 4 CUs and serve concurrently
            (composed: "multiple independent accelerators");
  phase 2 — A takes a traffic burst while B idles: the analytical policy
            grows A by taking B's CUs mid-stream (B keeps its requests
            until it is parked);
  phase 3 — a single large job arrives for A: the card unifies into the
            monolithic accelerator (the paper's CHARM-1 operating point is
            one composition of the same fabric);
  phase 4 — a heterogeneous fleet: transformer decode + Mamba SSM +
            encoder embedding + seamless enc-dec tenants share the card
            under class-aware costing (each workload priced by its bound
            resource).

    python -m repro_torch.launch.multi_tenant_serve [--device cpu]

Reduced configs; runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.common.platform import H100_SXM, per_cu
from repro_torch.serve import (AnalyticalPolicy, ComposedServer, ServeConfig,
                               TenantSpec)

NUM_CUS = 8


def run_phase(server, title, steps):
    for _ in range(steps):
        server.step()
    sizes = server.sizes()
    print(f"{title}: composition={sizes} "
          f"pending={ {t: ld.pending_tokens for t, ld in server.loads().items()} }")


def heterogeneous_fleet(device):
    """One card, four workload classes (FILCO's diverse-workload claim): a
    transformer decode tenant, a Mamba SSM tenant (constant-size recurrent
    state), an encoder tenant (prefill-only embeddings) and a seamless
    enc-dec tenant (batched bucketed encode + cross-attention decode)
    share 8 CUs under the class-aware analytical policy — each priced by
    its bound resource (weight bandwidth / state bandwidth / compute /
    decode GEMV + per-step cross-attention source reads)."""
    serve = ServeConfig(max_slots=2, max_len=48, eos_id=-1)
    s2t_serve = ServeConfig(max_slots=2, max_len=24, eos_id=-1,
                            max_src_len=32, len_buckets=(16,))
    server = ComposedServer(
        [TenantSpec("llm", "minitron-4b", serve=serve),
         TenantSpec("mamba", "falcon-mamba-7b", seed=1, serve=serve),
         TenantSpec("embed", "qwen2.5-32b", seed=2, serve=serve,
                    workload="encoder"),
         # workload="auto" derives "encdec" from the enc-dec architecture
         TenantSpec("s2t", "seamless-m4t-medium", seed=3, serve=s2t_serve)],
        num_cus=NUM_CUS, device=device,
        policy=AnalyticalPolicy(per_cu(H100_SXM, NUM_CUS)), decide_every=3)
    print(f"\nheterogeneous fleet: classes={server.classes} "
          f"composition={server.sizes()}")
    assert server.classes["s2t"] == "encdec"
    rng = np.random.default_rng(1)

    def traffic(name, n, new):
        vocab = server.cfgs[name].vocab_size
        for _ in range(n):
            server.submit(name, rng.integers(1, vocab, size=8),
                          max_new_tokens=new)

    # wave 1: decode + embedding + enc-dec traffic — the idle mamba tenant
    # is parked and its CUs go to the busy classes
    traffic("llm", 2, 10)
    traffic("embed", 4, 0)
    traffic("s2t", 2, 8)
    for _ in range(8):
        server.step()
    # wave 2: a mamba burst — the policy admits it back, taking CUs from
    # the winding-down classes (a live recomposition between classes)
    traffic("mamba", 3, 12)
    out = server.drain(max_steps=200)
    done = {t: len(d) for t, d in out.items()}
    print(f"completed per tenant: {done}")
    for e in server.events:
        print(f"  step {e.step:3d} [{e.reason}] {e.sizes_before} -> "
              f"{e.sizes_after}")
    assert done == {"llm": 2, "mamba": 3, "embed": 4, "s2t": 2}
    assert server.events, "expected the policy to recompose between classes"
    # embeddings are real vectors, not token streams
    emb = next(iter(server.engines["embed"].results().values()))
    assert len(emb) == server.cfgs["embed"].d_model
    # enc-dec jobs produce full decode streams through the fabric
    s2t_streams = server.engines["s2t"].results()
    assert all(len(toks) == 8 for toks in s2t_streams.values())
    print(f"s2t encode-bucket hits: "
          f"{server.engines['s2t'].stats()['bucket_hits']}")
    print("heterogeneous fleet OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
    server = ComposedServer(
        [TenantSpec("tenant-A", "minitron-4b", serve=serve),
         TenantSpec("tenant-B", "qwen2.5-32b", seed=1, serve=serve)],
        num_cus=NUM_CUS, device=args.device,
        policy=AnalyticalPolicy(per_cu(H100_SXM, NUM_CUS)), decide_every=4)
    print(f"fabric: one {server.device.type} device, "
          f"{server.composer.num_cus} logical CUs")
    print(f"initial composition: {server.sizes()}")

    rng = np.random.default_rng(0)

    def traffic(tenant, n, plen, new):
        vocab = server.cfgs[tenant].vocab_size
        for _ in range(n):
            server.submit(tenant, rng.integers(1, vocab, size=plen),
                          max_new_tokens=new)

    # phase 1: both tenants comparably loaded -> stay near the 4/4 split
    traffic("tenant-A", 2, 8, 8)
    traffic("tenant-B", 2, 8, 24)
    run_phase(server, "phase 1 (balanced)", 4)

    # phase 2: A bursts while B winds down -> the policy shifts B's CUs to
    # A (a live grow/shrink: B keeps serving, smaller)
    traffic("tenant-A", 6, 10, 16)
    run_phase(server, "phase 2 (A bursts)", 20)

    # phase 3: one large job for A -> the card unifies
    if server.sizes().get("tenant-A", 0) < server.composer.num_cus:
        server.unify("tenant-A")
    traffic("tenant-A", 1, 24, 24)
    run_phase(server, "phase 3 (unified)", 30)

    server.drain()
    print("\nrecomposition events:")
    for e in server.events:
        print(f"  step {e.step:3d} [{e.reason}] {e.sizes_before} -> "
              f"{e.sizes_after} moved={list(e.moved)} "
              f"({e.seconds * 1e3:.1f} ms)")
    assert server.events, "expected at least one live recomposition"
    assert any(max(e.sizes_after.values()) == server.composer.num_cus
               for e in server.events), "expected a unify step"
    print(f"\nstats: {server.stats()}")
    print("multi-tenant recomposition OK")
    heterogeneous_fleet(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
