"""Runs both sides of the sharded train step's tests
(``tests/test_torch_train_mesh_ssm.py``, ``..._families.py``): the
reference (``_torch_train_mesh_ref.py``, 8 fake JAX devices) and, as soon
as it has written its initial parameters and batches, the port
(``_torch_train_mesh_worker.py``, 8 gloo CPU ranks) beside it.  Also the
comparisons both modules make."""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"


def run_both(mode: str, d: Path, timeout: float = 900):
    """(reference output, port output) of ``mode``, each run once."""
    ref_path, init_path, port_path = d / "ref.pkl", d / "init.pkl", \
        d / "port.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    logs = [open(d / n, "w+") for n in ("ref.log", "port.log")]
    ref = subprocess.Popen([sys.executable,
                            str(TESTS / "_torch_train_mesh_ref.py"), mode,
                            str(init_path), str(ref_path)], cwd=ROOT,
                           env=env, stdout=logs[0], stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    while not init_path.exists() and ref.poll() is None:
        assert time.monotonic() < deadline, "reference: no init.pkl"
        time.sleep(0.2)
    procs = [ref]
    if init_path.exists():
        procs.append(subprocess.Popen(
            [sys.executable, str(TESTS / "_torch_train_mesh_worker.py"),
             mode, str(init_path), str(port_path)], cwd=ROOT, env=env,
            stdout=logs[1], stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 1))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for f in logs:
        f.seek(0)
        tails.append(f.read()[-4000:])
        f.close()
    assert rcs == [0] * 2, (rcs, tails)
    with open(ref_path, "rb") as f:
        ref_out = pickle.load(f)
    with open(init_path, "rb") as f:
        init = pickle.load(f)
    with open(port_path, "rb") as f:
        port_out = pickle.load(f)
    return init, ref_out, port_out


def flat(tree, path=()):
    """{dotted path: array} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat(sub, path + (str(i),)).items()}
    return {".".join(path): np.asarray(tree, np.float32)}


def port_tree(ref_params, arch: str):
    """The reference's parameter tree in the port's structure (the
    bridge), as numpy fp32."""
    import torch

    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_reduced

    t = params_from_jax(ref_params, get_reduced(arch), "cpu",
                        dtype=torch.float32)
    return flat(t)


def max_diff(got: dict, want: dict) -> dict:
    """{leaf: max abs difference} over the same leaves."""
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max()) for k in want}


def close(got, want, tol, rel):
    for g, w in zip(got, want):
        assert abs(g - w) <= tol * (abs(w) if rel else 1.0), (got, want)
