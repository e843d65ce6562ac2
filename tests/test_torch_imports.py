"""The port stands alone: no file of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or any module of the JAX package ``repro``
(``repro_torch`` itself is fine), no TPU constant enters the port, and
importing the port starts no build.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module


def test_port_imports_nothing_of_jax_or_repro():
    assert len(FILES) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in FILES for line, name in _imports(p) if _forbidden(name)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.workloads.decode, repro_torch.launch.serve\n"
            "import repro_torch.bridge\n"
            "import repro_torch.launch.dse_to_silicon\n"
            "import repro_torch.core.simulator, repro_torch.common\n"
            "import repro_torch.serve, repro_torch.serve.fabric\n"
            "import repro_torch.serve.dse, repro_torch.serve.traffic\n"
            "import repro_torch.core.composer, repro_torch.obs.accounting\n"
            "import repro_torch.workloads.encoder\n"
            "import repro_torch.workloads.encdec\n"
            "import repro_torch.configs.seamless_m4t_medium\n"
            "import repro_torch.core.gpu_modes, repro_torch.core.arena\n"
            "import repro_torch.launch.quickstart\n"
            "import repro_torch.launch.multi_tenant_serve\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert _build.load_library.cache_info().currsize == 0\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_tpu_profile_in_the_port():
    bad = [str(p.relative_to(ROOT)) for p in FILES
           if "TPU_V5E" in p.read_text()]
    assert not bad, bad


DISTRIBUTED = ("distribution/partitioning.py", "distribution/__init__.py",
               "launch/mesh.py", "optim/compression.py")


@pytest.mark.parametrize("rel", DISTRIBUTED)
def test_distributed_module_imports_nothing_of_jax_or_repro(rel):
    path = ROOT / "src" / "repro_torch" / rel
    assert path.exists(), rel
    bad = [name for _, name in _imports(path) if _forbidden(name)]
    assert not bad, (rel, bad)


def test_importing_the_distributed_layer_touches_no_process_group():
    """The mesh builders are functions: importing them (and the trainer and
    launcher that use them) initialises no process group and loads no
    JAX."""
    code = ("import sys\n"
            "import torch.distributed as dist\n"
            "import repro_torch.distribution, repro_torch.launch.mesh\n"
            "import repro_torch.optim.compression, repro_torch.launch.train\n"
            "from repro_torch.optim import compressed_psum, ErrorFeedback\n"
            "from repro_torch.train.trainer import setup_sharded_state\n"
            "assert not dist.is_initialized()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
