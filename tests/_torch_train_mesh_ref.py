"""The reference's side of ``tests/test_torch_train_mesh_ssm.py`` and
``tests/test_torch_train_mesh_families.py``: ``make_train_step`` on 8 fake
JAX devices, a (2 data, 4 model) mesh with ``AxisType.Auto`` (which the
installed JAX needs for a ``jit`` under a mesh), two steps with
``train_rules(sequence_parallel=False)`` and ``True``.

    python tests/_torch_train_mesh_ref.py MODE INIT_PICKLE OUT_PICKLE

MODE is ``ssm`` or ``families`` (``CASES``).  INIT_PICKLE is written
first, before any step runs: each arch's initial parameters (the
reference's ``model.init(jax.random.key(0))``, which
``setup_sharded_state`` draws alike), its optimizer and its two batches
(``make_pipeline(cfg, 16, 4, seed=0)``; frames from
``batch_with_frames`` for an enc-dec arch), so that the port's worker can
start on it.  OUT_PICKLE holds {(arch, dtype, sequence parallel):
(losses, final parameters)}.  XLA compiles at backend optimization level
0 (a third less CPU for these tiny configs, whose fp32 results move by
about 1e-6 with it, under the tests' 1e-5) and runs on one thread, as
``tests/test_torch_tp_fabric.py``'s reference does, so that the module
shares the CPU with the suite's other workers.
"""
import dataclasses
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_reduced  # noqa: E402
from repro.data import make_pipeline  # noqa: E402
from repro.distribution import partitioning as part  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro.train.trainer import (TrainConfig, make_train_step,  # noqa: E402
                                 setup_sharded_state)

# (arch, optimizer (None: its own), the dtypes and sequence parallelism
# each runs with)
FP32 = (("float32", False), ("float32", True))
CASES = {
    "ssm": (("falcon-mamba-7b", None, FP32 + (("bfloat16", True),)),
            ("hymba-1.5b", None, FP32 + (("bfloat16", True),))),
    "families": (("deepseek-v2-lite-16b", None, FP32),
                 ("seamless-m4t-medium", None, FP32),
                 ("arctic-480b", "adamw", FP32),
                 ("qwen1.5-110b", "adafactor", FP32)),
}
TRAIN = TrainConfig(steps=4, lr=1e-3, warmup=1)


def config(arch, optimizer, dtype="float32"):
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    return dataclasses.replace(cfg, optimizer=optimizer) if optimizer \
        else cfg


def batches(cfg):
    pipe = make_pipeline(cfg, 16, 4, seed=0)
    return [pipe.batch_with_frames(s, cfg.d_model) if cfg.is_encdec
            else pipe.batch(s) for s in range(2)]


def main(mode, init_path, out_path):
    init = {}
    for arch, optimizer, _ in CASES[mode]:
        cfg = config(arch, optimizer)
        init[arch] = {"optimizer": cfg.optimizer, "batches": batches(cfg),
                      "params0": jax.tree.map(np.asarray, part.strip(
                          build_model(cfg).init(jax.random.key(0))))}
    with open(init_path + ".tmp", "wb") as f:
        pickle.dump(init, f)
    os.rename(init_path + ".tmp", init_path)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, optimizer, runs in CASES[mode]:
        for dtype in sorted({dt for dt, _ in runs}):
            cfg = config(arch, optimizer, dtype)
            model = build_model(cfg)
            opt = make_optimizer(cfg.optimizer)
            # the parameters' layout does not depend on act_seq: one
            # sharded state serves both runs (the step does not donate it)
            p0, o0, _, _ = setup_sharded_state(
                model, opt, mesh, part.train_rules(), jax.random.key(0))
            for sp in [sp for dt, sp in runs if dt == dtype]:
                rules = part.train_rules(sequence_parallel=sp)
                # the rules' residual spec names "pod", which this mesh
                # lacks
                res = (part.sanitize_spec(
                    rules.spec(("batch", "act_seq", None)), mesh)
                    if sp else None)
                step = jax.jit(make_train_step(model, opt, TRAIN,
                                               residual_spec=res))
                p, o, losses = p0, o0, []
                with mesh:
                    for s, b in enumerate(init[arch]["batches"]):
                        p, o, m = step(p, o, jnp.asarray(s), {
                            k: jnp.asarray(v) for k, v in b.items()})
                        losses.append(float(m["loss"]))
                out[(arch, dtype, sp)] = (losses,
                                          jax.tree.map(np.asarray, p))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
