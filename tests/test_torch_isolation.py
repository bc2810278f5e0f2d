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


# The BC trainer, online-eval, encoder-zoo and int8-serving slices: their
# modules and entry points.
SLICE_MODULES = [f"pvr_habitat_tpu_torch.{name}" for name in (
    "main_bc_1", "main_bc_2", "main_bc_finetune", "main_test",
    "data.embed_pipeline", "ops.quantize",
    "models.clip", "models.maskrcnn", "train.bc", "train.bc_step",
    "train.evaluate", "train.optim", "envs.api", "envs.environment",
    "envs.fake_nav", "envs.make_env", "envs.wrappers", "data.formats",
    "data.sampler", "models.policy", "ops.lstm", "utils.checkpoint",
    "utils.flags", "utils.profiling", "utils.stats",
    "tools.save_embedded_obs", "tools.save_opt_trajectories")]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pvr_habitat_tpu_torch.__path__, "pvr_habitat_tpu_torch."))


def test_every_module_imports_without_jax():
    modules = _modules()
    assert "pvr_habitat_tpu_torch.ops.cuda.fused_bottleneck" in modules
    assert "pvr_habitat_tpu_torch.ops.cuda.attention" in modules
    assert "pvr_habitat_tpu_torch.models.vit" in modules
    assert set(SLICE_MODULES) <= set(modules)
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
    for name in SLICE_MODULES:
        assert PORT / (name.split(".", 1)[1].replace(".", "/") + ".py") \
            in files, name
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
