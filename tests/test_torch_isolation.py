"""The port stands alone: nothing under src/repro_torch, and none of
chip_smoke.py, scripts/verify_torch.py, scripts/autotune_torch.py and
scripts/xlstm_mesh_bf16.py, imports jax, ``ml_dtypes`` or the JAX package ``repro`` (only the tests
import both), and
importing repro_torch (the time model and the autotuner too) loads no jax
module; importing the mesh and dry-run modules sets up no process
group."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "verify_torch.py",
    ROOT / "scripts" / "autotune_torch.py",
    ROOT / "scripts" / "xlstm_mesh_bf16.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.ops, repro_torch.convert, "
            "repro_torch.configs.resnet50_convs, repro_torch.configs, "
            "repro_torch.configs.qwen2_5_3b, repro_torch.configs.xlstm_1_3b, "
            "repro_torch.models, repro_torch.models.xlstm, "
            "repro_torch.models.scan_util, "
            "repro_torch.serving, repro_torch.resilience, "
            "repro_torch.launch.serve, repro_torch.analysis.roofline, "
            "repro_torch.analysis.timing, repro_torch.plan.autotune, "
            "repro_torch.data, repro_torch.train, repro_torch.launch.train, "
            "repro_torch.distributed, repro_torch.launch.mesh, "
            "repro_torch.core.hbl, repro_torch.core.algorithms, "
            "repro_torch.models.sharding, repro_torch.models.spmd, "
            "repro_torch.dtensors, repro_torch.launch.specs, repro_torch.launch.dryrun, "
            "repro_torch.analysis.report; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_mesh_modules_import_touches_no_group_or_device():
    """Importing the mesh, sharding, spec and dry-run modules sets up no
    process group and initializes no card (the dry run's fake group and a
    mesh trainer's gloo group come with their calls)."""
    code = ("import sys, torch, torch.distributed as dist, "
            "repro_torch.launch.mesh, repro_torch.models.sharding, "
            "repro_torch.models.spmd, repro_torch.dtensors, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun, repro_torch.analysis.report, "
            "repro_torch.train.trainer; "
            "bad = [dist.is_initialized(), torch.cuda.is_initialized()]; "
            "print(bad); sys.exit(1 if any(bad) else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
