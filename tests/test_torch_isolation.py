"""The port stands alone: every module of ``pvr_habitat_tpu_torch``
imports with jax and the JAX package blocked, and no source of the port
(nor chip_smoke.py) imports the JAX package."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pvr_habitat_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pvr_habitat_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pvr_habitat_tpu_torch.__path__, "pvr_habitat_tpu_torch."))


def test_every_module_imports_without_jax():
    modules = _modules()
    assert "pvr_habitat_tpu_torch.ops.cuda.fused_bottleneck" in modules
    assert "pvr_habitat_tpu_torch.ops.cuda.attention" in modules
    assert "pvr_habitat_tpu_torch.models.vit" in modules
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['pvr_habitat_tpu'] = None\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|pvr_habitat_tpu)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
