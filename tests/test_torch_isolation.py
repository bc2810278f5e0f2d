"""The port stands alone: every module of ``pvr_habitat_tpu_torch``
imports with jax and the JAX package blocked, and no source of the port
(nor chip_smoke.py) imports the JAX package."""

import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pvr_habitat_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pvr_habitat_tpu_torch"


# The BC trainer, online-eval, encoder-zoo, int8-serving,
# serving/scale-out and sweep/adapter/tensor-parallel slices: their
# modules and entry points.
SLICE_MODULES = [f"pvr_habitat_tpu_torch.{name}" for name in (
    "main_bc_1", "main_bc_2", "main_bc_finetune", "main_test",
    "data.embed_pipeline", "ops.quantize",
    "models.clip", "models.maskrcnn", "train.bc", "train.bc_step",
    "train.evaluate", "train.optim", "envs.api", "envs.environment",
    "envs.fake_nav", "envs.make_env", "envs.wrappers", "data.formats",
    "data.sampler", "models.policy", "ops.lstm", "utils.checkpoint",
    "utils.flags", "utils.profiling", "utils.stats",
    "tools.save_embedded_obs", "tools.save_opt_trajectories",
    "tools.serve_embeddings", "data.native",
    "tools.save_opt_trajectories_png", "tools.save_opt_trajectories_jpeg",
    "tools.make_episode_dataset", "tools.gen_all", "parallel.multihost",
    "parallel.mesh", "parallel.dryrun", "envs.gym_adapter",
    "envs.habitat_adapter", "tools.convert_checkpoint", "tools.sweep")]


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


def test_no_port_module_writes_under_native(tmp_path):
    """The codec is built from ``native/image_codec.cpp`` into
    ``build/codec/``: in a copy of the port and of ``native/``, building
    it, writing and reading a PNG trajectory leaves ``native/`` as it
    was."""
    shutil.copytree(PORT, tmp_path / PORT.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    before = sorted(p.name for p in (tmp_path / "native").iterdir())
    code = ("import numpy as np\n"
            "from pvr_habitat_tpu_torch.data import formats, native\n"
            "assert native.available(), native._why\n"
            "obs = [np.full((64, 64, 6), 7, np.uint8)] * 2\n"
            "formats.save_png_trajectory('traj', 0, obs, np.zeros(2), "
            "np.zeros(2), np.zeros(2), np.zeros((2, 12)))\n"
            "data = formats.read_png_trajectories('traj')\n"
            "assert (data['obs'] == 7).all()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == before
    assert len(list((tmp_path / "build" / "codec").glob("*.so"))) == 1
