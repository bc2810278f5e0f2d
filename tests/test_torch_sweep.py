"""The port's sweep (``tools/sweep.py``) against the JAX sweep: the
default grids of the BC, finetune and embedding sweeps give the same
jobs (xpids and flags on the keys both parsers have), the completed-run
skip agrees on the same stats pickles, subprocess jobs run the port's
CLIs with ``--disable_cuda`` carried through, the submitit job specs are
the JAX executor's (on the fake ``submitit`` of
``tests/test_submitit_executor.py``), and a tiny sweep runs end to end
on the CPU, in process and as a subprocess job, and skips on rerun."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from pvr_habitat_tpu.tools import sweep as jsweep
from pvr_habitat_tpu.utils import flags as jflags
from pvr_habitat_tpu_torch.data import formats
from pvr_habitat_tpu_torch.tools import save_opt_trajectories as datagen
from pvr_habitat_tpu_torch.tools import sweep
from pvr_habitat_tpu_torch.utils import flags
from tests.test_submitit_executor import fake_submitit  # noqa: F401


def _same_jobs(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = vars(g), vars(w)
        shared = set(g) & set(w)
        assert {"xpid", "env", "to_env", "embedding_name", "run_id",
                "max_frames", "batch_norm", "essential_save_only"} <= shared
        assert {k: g[k] for k in shared} == {k: w[k] for k in shared}


@pytest.mark.parametrize("kind", ["bc", "finetune", "embed"])
def test_default_grids_give_the_jax_jobs(kind, tmp_path, monkeypatch):
    """Dry runs of each default grid (35 embeddings x 5 scenes x 10 seeds
    for BC) in an empty directory: the same jobs in the same order."""
    monkeypatch.chdir(tmp_path)
    jobs = []
    for module in (jsweep, sweep):
        if kind == "embed":
            jobs.append(module.run_embedding_sweep(
                module.default_embedding_grid(), dry_run=True,
                data_path=str(tmp_path)))
            continue
        grid = module.default_bc_grid("FakeImageNav")
        if kind == "finetune":
            grid["embedding_name"] = ["random"]
        jobs.append(module.run_bc_sweep(grid, dry_run=True,
                                        finetune=kind == "finetune"))
    _same_jobs(jobs[1], jobs[0])
    if kind == "bc":
        assert len(jobs[1]) == 35 * 5 * 10
    if kind == "embed":
        assert {f.source for f in jobs[1]} == {"pickle"}
        assert len(jobs[1]) == 35 * 5


def _stats(path, frames):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as handle:
        pickle.dump({"FakeImageNav-room_0": {"frames": [frames]}}, handle)


@pytest.mark.parametrize("label", [None, "random_finetuned"])
def test_completed_run_skip_agrees(label, tmp_path):
    """``is_run_completed`` on the same pickles, around the unroll*batch
    tolerance, in both packages."""
    kw = dict(env="FakeImageNav-room_0", to_env="FakeImageNav-room_0",
              embedding_name="resnet50", save_path=str(tmp_path),
              max_frames=1000, batch_size=4, unroll_length=10)
    port, jax_ = flags.default_flags(**kw), jflags.default_flags(**kw)
    path = sweep.stats_util.run_save_path(port, label) + ".pickle"
    assert path == jsweep.stats_util.run_save_path(jax_, label) + ".pickle"
    seen = []
    for frames in (None, 0, 959, 960, 1000):
        if frames is not None:
            _stats(path, frames)
        got = sweep.is_run_completed(port, label)
        assert got == jsweep.is_run_completed(jax_, label)
        seen.append(got)
    assert seen == [False, False, False, True, True]


class _Run:
    def __init__(self):
        self.calls = []

    def __call__(self, cmd, **kwargs):
        self.calls.append((cmd, kwargs))
        return subprocess.CompletedProcess(cmd, 0)


@pytest.mark.parametrize("runner,module", [
    ("runner_random", "pvr_habitat_tpu_torch.main_bc_1"),
    ("runner_pvr", "pvr_habitat_tpu_torch.main_bc_2"),
    ("runner_finetune", "pvr_habitat_tpu_torch.main_bc_finetune")])
def test_subprocess_jobs_run_the_port_clis(runner, module, monkeypatch):
    """Each runner maps to the port's module, run with ``python -m`` from
    the repository's root (never a top-level ``main_*.py``, which runs
    the JAX trainer); the flags that differ from the port's defaults are
    on the command line, ``--disable_cuda`` among them, and parse back
    to the same flags."""
    run = _Run()
    monkeypatch.setattr(sweep.subprocess, "run", run)
    fl = flags.default_flags(env="FakeImageNav-room_0", run_id=3,
                             batch_norm=True, disable_cuda=True,
                             pretrained_embedding=False, xpid="ri=3")

    def job(f):
        raise AssertionError("a subprocess job ran in process")

    job.__name__ = runner
    assert sweep.SubprocessExecutor().submit(job, fl) == "subprocess:0"
    (cmd, kwargs), = run.calls
    assert cmd[:3] == [sys.executable, "-m", module]
    assert not any(arg.endswith(".py") for arg in cmd)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert kwargs["cwd"] == root
    assert "--disable_cuda" in cmd and "--disable_pretrained_embedding" \
        in cmd
    assert vars(flags.build_parser().parse_args(cmd[3:])) == vars(fl)


def test_submitit_job_specs_are_the_jax_ones(fake_submitit):  # noqa: F811
    scenes = "FakeImageNav-apartment_0,FakeImageNav-room_0"
    cases = [dict(env=scenes, to_env="FakeImageNav-room_0",
                  embedding_name=name)
             for name in ("resnet50", "moco_croponly_uber_345", "random")]
    for kw in (dict(partition="learnfair"),
               dict(partition="p", kind="embed", debug=True,
                    constraint="h100", gres="gpu:1", comment="c"),
               dict(partition="p", local=True)):
        for case in cases:
            specs = []
            for module, fl in ((jsweep, jflags), (sweep, flags)):
                ex = module.SubmititExecutor(**kw)
                f = fl.default_flags(**case)
                specs.append(ex.job_spec(f))
                ex.submit(lambda f: None, f)
                specs.append(ex._executor.updates[-1])
            assert specs[2:] == specs[:2], (kw, case)
    ex = sweep.SubmititExecutor(partition="learnfair")
    assert "constraint" not in ex.job_spec(flags.default_flags())
    assert "gres" not in ex.job_spec(flags.default_flags())


def _data(tmp_path, env):
    """Raw trajectories of ``env`` and their true-state pickle."""
    fl = datagen.build_tool_parser().parse_args(
        ["--env", env, "--save_path", str(tmp_path), "--n_trajectories",
         "3", "--max_episode_steps", "25"])
    datagen.gen_data_habitat(fl)
    raw = formats.load_pickle(formats.raw_path(str(tmp_path), env))
    data = {k: np.concatenate(raw[k])
            for k in ("action", "reward", "done", "true_state")}
    formats.save_embedded(
        formats.embedded_path(str(tmp_path), env, "resnet50"),
        np.zeros((len(data["action"]), 4), np.float32),
        data["action"], data["reward"], data["done"], data["true_state"])


def test_local_sweep_end_to_end_on_the_cpu(tmp_path):
    """A tiny BC sweep (a true_state job in process through
    ``LocalExecutor``, its second seed as a subprocess job) and a
    ``random`` embedding sweep run on the CPU; each writes its outputs,
    and a rerun submits nothing."""
    env = "FakeImageNav-room_0"
    _data(tmp_path, env)
    latest = os.path.join(str(tmp_path), "latest")
    grid = dict(
        env=[env], to_env=[env], embedding_name=["true_state"], run_id=[1],
        save_path=[latest], data_path=[str(tmp_path)], batch_size=[2],
        unroll_length=[5], n_episodes_test=[1], eval_frequency=[1],
        max_episode_steps=[15], debug=[True], disable_cuda=True)
    frames = {env: 2 * 5 * 2}
    assert sweep.run_bc_sweep(grid, sweep.LocalExecutor(),
                              max_frames_map=frames) == ["local"]
    assert sweep.run_bc_sweep({**grid, "run_id": [1, 2]},
                              sweep.SubprocessExecutor(),
                              max_frames_map=frames) == ["subprocess:0"]
    for seed in (1, 2):
        stem = os.path.join(latest, f"{env}_emtrue_state_s{seed}_{env}")
        assert os.path.isfile(stem + ".pickle"), seed
        assert os.path.isfile(stem + ".tar"), seed
        stats = formats.load_pickle(stem + ".pickle")[env]
        assert np.isfinite(stats["training_loss"][1:]).all()
    assert sweep.run_bc_sweep({**grid, "run_id": [1, 2]},
                              sweep.LocalExecutor(),
                              max_frames_map=frames) == []

    embed = dict(env=[env], embedding_name=["random"], batch_size=[32],
                 disable_cuda=True)
    assert sweep.run_embedding_sweep(embed, data_path=str(tmp_path)) == \
        ["local"]
    data = formats.load_pickle(
        formats.embedded_path(str(tmp_path), env, "random"))
    assert data["obs"].shape[1] == 1568 * 2      # ImageNav: goal frame too
    assert sweep.run_embedding_sweep(embed, data_path=str(tmp_path)) == []


def test_main_routes_each_kind(monkeypatch):
    """``python -m pvr_habitat_tpu_torch.tools.sweep --kind ...`` sweeps
    the JAX sweep's default grids, with ``--disable_cuda`` on every job."""
    seen = []
    monkeypatch.setattr(sweep, "run_bc_sweep", lambda grid, ex, **kw:
                        seen.append(("bc", grid, kw)))
    monkeypatch.setattr(sweep, "run_embedding_sweep", lambda grid, ex:
                        seen.append(("embed", grid, {})))
    for kind in ("bc", "embed", "finetune"):
        sweep.main(["--kind", kind, "--local", "--fake", "--disable_cuda"])
    (bc, grid, kw), (embed, egrid, _), (ft, fgrid, fkw) = seen
    assert grid == {**jsweep.default_bc_grid("FakeImageNav"),
                    "disable_cuda": True} and kw == {"debug": False}
    assert egrid == {**jsweep.default_embedding_grid("FakeImageNav"),
                     "disable_cuda": True}
    assert fgrid["embedding_name"] == ["random"] and fkw["finetune"]
