"""The port's datagen tools against the JAX package's with the same flags
(CPU, FakeNav): ``save_opt_trajectories_png`` and ``_jpeg`` on a
PointNav and an ImageNav scene write the same files (names, frames and
metadata), ``make_episode_dataset`` the same episode file, and
``gen_all --fake`` the same datasets."""

import gzip
import json
import os
import pickle
import sys

import numpy as np
import pytest

from pvr_habitat_tpu.tools import gen_all as jgen_all
from pvr_habitat_tpu.tools import make_episode_dataset as jmake_episodes
from pvr_habitat_tpu.tools import save_opt_trajectories_jpeg as jjpeg
from pvr_habitat_tpu.tools import save_opt_trajectories_png as jpng
from pvr_habitat_tpu_torch.tools import (gen_all, make_episode_dataset,
                                         save_opt_trajectories_jpeg,
                                         save_opt_trajectories_png)

TOOLS = {"png": (jpng, save_opt_trajectories_png, "build_tool_parser"),
         "jpeg": (jjpeg, save_opt_trajectories_jpeg, "build_jpeg_parser")}


def _load(path):
    with open(path, "rb") as handle:
        return pickle.load(handle)


def _assert_same(a, b):
    """Two values of a metadata pickle: dicts of arrays or one array."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    else:
        np.testing.assert_array_equal(a, b)


def _assert_same_tree(got, want):
    """Same files; images byte for byte (the same cv2 / PIL encoders
    here), pickles by content."""
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and names
    for name in names:
        g, w = os.path.join(got, name), os.path.join(want, name)
        if os.path.isdir(w):
            _assert_same_tree(g, w)
        elif name.endswith(".pickle"):
            _assert_same(_load(g), _load(w))
        else:
            with open(g, "rb") as fg, open(w, "rb") as fw:
                assert fg.read() == fw.read(), name


@pytest.mark.parametrize("layout", ["png", "jpeg"])
@pytest.mark.parametrize("env", ["FakePointNav-hotel_0",
                                 "FakeImageNav-office_0"])
def test_datagen_writes_what_jax_writes(tmp_path, layout, env):
    jax_tool, port_tool, parser = TOOLS[layout]
    args = ["--env", env, "--n_trajectories", "2",
            "--max_episode_steps", "20"]
    dirs = {}
    for label, tool in (("jax", jax_tool), ("port", port_tool)):
        flags = getattr(tool, parser)().parse_args(
            args + ["--save_path", str(tmp_path / label)])
        dirs[label] = tool.gen_data_habitat(flags)
    assert dirs["port"] == str(tmp_path / "port" / env)
    _assert_same_tree(dirs["port"], dirs["jax"])
    names = os.listdir(dirs["port"])
    assert "0.pickle" in names and "1.pickle" in names
    goal = "0_goal.png" in names
    assert goal == (layout == "png" and "ImageNav" in env)


@pytest.mark.parametrize("out", ["episodes.json.gz", "sub/episodes.json"])
def test_make_episode_dataset_matches_jax(tmp_path, monkeypatch, out):
    files = {}
    for label, module in (("jax", jmake_episodes),
                          ("port", make_episode_dataset)):
        path = str(tmp_path / label / out)
        monkeypatch.setattr(sys, "argv", [
            "make_episode_dataset", "--scene_path", "apt/mesh.ply",
            "--out", path])
        module.main()
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as handle:
            files[label] = json.load(handle)
    assert files["port"] == files["jax"]
    assert files["port"]["episodes"][0]["scene_id"] == "apt/mesh.ply"


@pytest.mark.parametrize("layout", ["pickle", "png"])
def test_gen_all_fake_matches_jax(tmp_path, monkeypatch, layout):
    for label, module in (("jax", jgen_all), ("port", gen_all)):
        monkeypatch.setattr(sys, "argv", [
            "gen_all", "--layout", layout, "--fake", "--n_trajectories", "1",
            "--max_episode_steps", "12", "--save_path",
            str(tmp_path / label)])
        module.main()
    assert gen_all.BC_SCENES == jgen_all.BC_SCENES
    assert gen_all.ALL_SCENES == jgen_all.ALL_SCENES
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    stems = [f"FakePointNav-{scene}" for scene in gen_all.BC_SCENES]
    if layout == "pickle":
        assert names == sorted(s + ".pickle" for s in stems)
    else:
        assert names == sorted(stems)
