"""The slice as a whole: the port's BC trainer and online eval against the
JAX package's on one FakeNav dataset written by the JAX tools (CPU,
``random`` encoder, small budgets): the stats pickles, the losses and
gradient norms at rtol 1e-4, equal eval episodes, checkpoints that load
both ways, resume, the completed-run exit, embed-at-load with the fused
ImageNav runner, the CLIs as subprocesses, and one full-width eval case
through ResNet-50 f32."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import main_test as jmain_test
from pvr_habitat_tpu.data import formats as jformats
from pvr_habitat_tpu.envs import environment as jenvironment
from pvr_habitat_tpu.models import policy as jpolicy
from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu.tools import save_embedded_obs as jembed
from pvr_habitat_tpu.tools import save_opt_trajectories as jdatagen
from pvr_habitat_tpu.train import bc as jbc
from pvr_habitat_tpu.train import evaluate as jevaluate
from pvr_habitat_tpu.utils import checkpoint as jckpt
from pvr_habitat_tpu.utils import stats as jstats
from pvr_habitat_tpu_torch import main_bc_1, main_bc_2
from pvr_habitat_tpu_torch import main_test
from pvr_habitat_tpu_torch.envs import environment
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.parallel import mesh as pmesh
from pvr_habitat_tpu_torch.train import bc, evaluate
from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
from pvr_habitat_tpu_torch.utils.flags import default_flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "FakePointNav-apartment_0"
IMAGENAV = "FakeImageNav-hotel_0"
METRIC_RTOL = 1e-4   # training_loss and gradient_norm, port vs JAX
STEM = f"{ENV}_emrandom_s1_{ENV}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs in several worker processes on a few cores: torch's
    and BLAS's thread pools stay at one thread here, so that these tests
    do not starve the other workers (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(threads)


def _datagen(module, env, path, n_trajectories):
    fl = module.build_tool_parser().parse_args(
        ["--env", env, "--save_path", str(path), "--n_trajectories",
         str(n_trajectories), "--max_episode_steps", "60"])
    return module.gen_data_habitat(fl)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Raw and embedded FakePointNav data written by the JAX tools."""
    path = tmp_path_factory.mktemp("bc")
    _datagen(jdatagen, ENV, path, 4)
    fl = jembed.build_tool_parser().parse_args(
        ["--env", ENV, "--data_path", str(path), "--embedding_name",
         "random", "--source", "pickle", "--batch_size", "64"])
    jembed.run(fl)
    return path


def _flags(workdir, save, **kw):
    base = dict(env=ENV, to_env=ENV, data_path=str(workdir),
                save_path=os.path.join(str(workdir), save),
                embedding_name="random", batch_size=4, unroll_length=10,
                max_frames=4 * 10 * 4, eval_frequency=2, n_episodes_test=2,
                max_episode_steps=10, disable_cuda=True)
    base.update(kw)
    return default_flags(**base)


def _assert_stats_match(got, want, to_env):
    assert set(got) == set(want) == {to_env}
    g, w = got[to_env], want[to_env]
    assert set(g) == set(w)
    for key in w:
        assert len(g[key]) == len(w[key]), key
    assert g["frames"] == w["frames"]
    for key in ("training_loss", "gradient_norm"):
        np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL,
                                   err_msg=key)
    for key in ("episode_return", "episode_success"):
        assert g[key] == w[key], key


def _main_test(module, flags, workdir):
    cwd = os.getcwd()
    os.chdir(str(workdir))
    try:
        return module.run(flags)
    finally:
        os.chdir(cwd)


def _main_test_flags(module, workdir, checkpoint):
    fl = module.parser.parse_args(
        ["--checkpoint", checkpoint, "--env", ENV, "--from_env", ENV,
         "--embedding_name", "random", "--data_path", str(workdir),
         "--n_episodes_test", "2", "--max_episode_steps", "10",
         "--disable_cuda"])
    return fl


def test_precomputed_run_matches_jax_and_checkpoints_interoperate(workdir):
    want = jbc.run(_flags(workdir, "jax_bc"), mode="precomputed")
    got = main_bc_2.run(_flags(workdir, "port_bc"))
    _assert_stats_match(got, want, ENV)
    # initial eval + evals at epochs 2 and 4
    assert got[ENV]["frames"] == [0, 40, 120]
    # the pickles on disk are the returned stats, in the JAX layout
    for save, stats in (("jax_bc", want), ("port_bc", got)):
        on_disk = jstats.load_stats(os.path.join(str(workdir), save,
                                                 STEM + ".pickle"))
        _assert_stats_match(on_disk, stats, ENV)

    port_tar = os.path.join(str(workdir), "port_bc", STEM + ".tar")
    jax_tar = os.path.join(str(workdir), "jax_bc", STEM + ".tar")
    jpayload, payload = jckpt.load_checkpoint(jax_tar), \
        ckpt.load_checkpoint(port_tar)
    assert set(payload) == set(jpayload)
    assert payload["scheduler_state_dict"] == \
        jpayload["scheduler_state_dict"] == {"last_epoch": 4}
    for key, value in jpayload["actor_model_state_dict"].items():
        np.testing.assert_allclose(payload["actor_model_state_dict"][key],
                                   value, atol=1e-4, err_msg=key)
    for key, value in jpayload["embedding_model_state_dict"].items():
        np.testing.assert_allclose(
            payload["embedding_model_state_dict"][key], value, atol=1e-6)

    # the port's checkpoint in both evaluators: equal episode stats; the
    # JAX one in the port's
    on_port = _main_test(jmain_test, _main_test_flags(jmain_test, workdir,
                                                      port_tar), workdir)
    assert _main_test(main_test, _main_test_flags(main_test, workdir,
                                                  port_tar), workdir) == \
        on_port
    assert set(on_port) == {"episode_return", "episode_step",
                            "episode_success"}
    on_jax = _main_test(main_test, _main_test_flags(main_test, workdir,
                                                    jax_tar), workdir)
    assert on_jax.keys() == on_port.keys()
    assert all(len(v) == 2 for v in on_jax.values())
    assert os.path.isfile(os.path.join(
        str(workdir), f"test_random_from_{ENV}_to_{ENV}_1.pickle"))


def test_resume_and_completed_run(workdir):
    first = main_bc_2.run(_flags(workdir, "resume", max_frames=4 * 10 * 2))
    assert first[ENV]["frames"] == [0, 40]
    # a run already at its budget stops at once (main_bc_2.py:50-56)
    assert main_bc_2.run(_flags(workdir, "resume", max_frames=40)) is None
    # a larger budget resumes from the checkpoint and its last logged
    # frame count (as the reference and the JAX package do), without an
    # initial eval
    resumed = main_bc_2.run(_flags(workdir, "resume", max_frames=4 * 10 * 4))
    s = resumed[ENV]
    assert s["frames"] == [0, 40, 40, 120]
    assert s["training_loss"][1] == first[ENV]["training_loss"][1]
    assert np.isfinite(s["training_loss"][2:]).all()
    payload = ckpt.load_checkpoint(os.path.join(str(workdir), "resume",
                                                STEM + ".tar"))
    # 2 steps, then epochs 1 to 3 again
    assert payload["actor_model_optimizer_state_dict"]["count"] == 5


def test_embed_at_load_imagenav_fused_eval_matches_jax(workdir):
    """main_bc_1 on raw ImageNav frames, eval on 2 lockstep envs through
    the fused runner with its goal-embedding cache."""
    _datagen(jdatagen, IMAGENAV, workdir, 2)
    kw = dict(env=IMAGENAV, to_env=IMAGENAV, eval_batch=2,
              max_frames=4 * 10 * 2)
    want = jbc.run(_flags(workdir, "jax_bc1", **kw), mode="embed_at_load")
    got = main_bc_1.run(_flags(workdir, "port_bc1", **kw))
    _assert_stats_match(got, want, IMAGENAV)
    assert len(got[IMAGENAV]["frames"]) == 2


def test_unported_options_raise(workdir):
    """A mesh of more devices than processes raises with the JAX package's
    message (a one-process run on a 'model' axis of 2 too); a 'model'
    axis above 1 (tensor parallelism) builds the mesh
    (``tests/test_torch_tensor_parallel.py`` trains on it); without CUDA
    nothing falls back to the CPU."""
    with pytest.raises(ValueError, match=r"mesh \(2, 1\) != 1 devices"):
        bc.run(_flags(workdir, "x", mesh_shape="2,1"))
    with pytest.raises(ValueError, match=r"mesh \(3, 3\) != 1 devices"):
        bc.run(_flags(workdir, "x", mesh_shape="3,3"))
    with pytest.raises(ValueError, match=r"mesh \(1, 2\) != 1 devices"):
        bc.run(_flags(workdir, "x", mesh_shape="1,2"))
    assert pmesh.make_mesh((1, 2), n_devices=2).shape == \
        {"data": 1, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bc.run(_flags(workdir, "x", disable_cuda=False))


def test_cli_pipeline_subprocesses(tmp_path):
    """The four stages with --disable_cuda, each run as ``__main__`` of its
    module (what ``python -m`` does) with its own argv, in one child
    process with jax blocked (one interpreter start, not four)."""
    w = str(tmp_path)
    common = ["--env", ENV, "--disable_cuda"]
    stages = [
        ("pvr_habitat_tpu_torch.tools.save_opt_trajectories",
         ["--save_path", w, "--n_trajectories", "2",
          "--max_episode_steps", "40"]),
        ("pvr_habitat_tpu_torch.tools.save_embedded_obs",
         ["--embedding_name", "random", "--source", "pickle",
          "--data_path", w, "--batch_size", "64"]),
        ("pvr_habitat_tpu_torch.main_bc_2",
         ["--to_env", ENV, "--embedding_name", "random", "--data_path", w,
          "--save_path", os.path.join(w, "bc"), "--batch_size", "2",
          "--unroll_length", "10", "--max_frames", "40",
          "--eval_frequency", "2", "--n_episodes_test", "1",
          "--max_episode_steps", "10"]),
        ("pvr_habitat_tpu_torch.main_test",
         ["--checkpoint", os.path.join(w, "bc", STEM + ".tar"),
          "--from_env", ENV, "--embedding_name", "random", "--data_path", w,
          "--n_episodes_test", "1", "--max_episode_steps", "10"]),
    ]
    code = "\n".join(
        ["import runpy, sys", "sys.modules['jax'] = None"]
        + [f"sys.argv = [{module!r}, *{[*common, *args]!r}]\n"
           f"print('stage', {module!r}, file=sys.stderr)\n"
           f"runpy.run_module({module!r}, run_name='__main__')"
           for module, args in stages])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=w,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
             "OPENBLAS_NUM_THREADS": "1"}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("stage ") == len(stages)
    for name in (f"{ENV}.pickle", f"{ENV}_random.pickle", "random_1.tar",
                 os.path.join("bc", STEM + ".pickle"),
                 os.path.join("bc", STEM + ".tar"),
                 f"test_random_from_{ENV}_to_{ENV}_1.pickle"):
        assert os.path.isfile(os.path.join(w, name)), name
    assert jformats.load_pickle(os.path.join(w, f"{ENV}_random.pickle"))[
        "obs"].shape[1] == 1568


class _ActionLog:
    """Wraps an eval runner and records the action of every env step."""

    def __init__(self, runner):
        self.runner, self.actions = runner, []

    def initial_state(self, batch_size=1):
        return self.runner.initial_state(batch_size)

    def __call__(self, env_output, core_state):
        out, core_state = self.runner(env_output, core_state)
        self.actions.append(int(np.asarray(out["action"]).reshape(-1)[0]))
        return out, core_state


def test_full_width_resnet50_eval_matches_jax():
    """ResNet-50 f32 (2048-d) into the reference policy: the same actions
    and episode stats over a few env steps, the port's encoder on its
    kernel route ``v1`` (the kernel's plain version on the CPU)."""
    fl = default_flags(env=ENV, embedding_name="resnet50",
                       max_episode_steps=6)
    jnet = JaxNet("resnet50", pretrained=False)
    net = EmbeddingNet("resnet50", pretrained=False, device="cpu",
                       fused="v1")
    params, stats = jpolicy.init_policy_params(
        np.random.RandomState(0), 2048, 3)
    jrunner = _ActionLog(jevaluate.PolicyRunner(params, stats))
    runner = _ActionLog(evaluate.PolicyRunner(
        {k: torch.tensor(np.asarray(v)) for k, v in params.items()}))
    keys = ["episode_return", "episode_step", "episode_success"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jevaluate.test(jrunner, jenvironment.make_environment(
            fl, jnet), keys, n_episodes=1)
        got = evaluate.test(runner, environment.make_environment(fl, net),
                            keys, n_episodes=1)
    assert len(runner.actions) == 6
    assert runner.actions == jrunner.actions
    assert got == want and got["episode_step"] == [6.0]
