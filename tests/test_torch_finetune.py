"""The finetune path of the port against the JAX package's (CPU, f32): the
conv policy over raw pixels (PointNav 3 channels, ImageNav 2 frames of 3)
with and without BatchNorm, train and eval mode, outputs and gradients
at 1e-5 elementwise, so the reference's H/W swap and dim-3 frame
concatenation are held element by element; the init draw for draw; one
train step's gradients (through the loss and the clip) at 1e-4; and
``run(mode="finetune")`` of both packages on one raw FakeNav pickle:
losses and gradient norms at rtol 1e-4, the same eval episodes, output
files named ``..._emrandom_finetuned_s1_...`` with no encoder state in
the checkpoint, and the CLI module."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.models import policy as jpolicy
from pvr_habitat_tpu.tools import save_opt_trajectories as jdatagen
from pvr_habitat_tpu.train import bc as jbc
from pvr_habitat_tpu.train import bc_step as jbc_step
from pvr_habitat_tpu.train import evaluate as jevaluate
from pvr_habitat_tpu.utils import checkpoint as jckpt
from pvr_habitat_tpu_torch import main_bc_finetune
from pvr_habitat_tpu_torch.data import sampler
from pvr_habitat_tpu_torch.models import convert, policy
from pvr_habitat_tpu_torch.train import bc_step, evaluate
from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
from pvr_habitat_tpu_torch.utils.flags import default_flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5            # the conv policy's outputs and gradients
GRAD_TOL = 1e-4       # one train step's clipped gradients
METRIC_RTOL = 1e-4    # training_loss and gradient_norm, port vs JAX
T, B, HW, ACTIONS = 3, 2, 64, 3
ENV = "FakePointNav-apartment_0"
STEM = f"{ENV}_emrandom_finetuned_s1_{ENV}"


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


def _port(tree):
    """JAX layout (HWIO convs) -> the port's tensors (OIHW)."""
    return convert.params_from_numpy(
        {k: np.asarray(v) for k, v in tree.items()}, "cpu")


def _params(channels, batch_norm, seed=1):
    params, stats = jpolicy.init_conv_policy_params(
        np.random.RandomState(seed), (HW, HW, channels), ACTIONS,
        batch_norm=batch_norm)
    if batch_norm:   # non-trivial BN parameters and running stats
        rng = np.random.RandomState(seed + 1)
        n = params["fc.0.weight"].shape[0]
        params["fc.0.weight"] = jnp.asarray(
            1 + 0.1 * rng.randn(n).astype(np.float32))
        params["fc.0.bias"] = jnp.asarray(0.1 * rng.randn(n)
                                          .astype(np.float32))
        stats = {"fc.0.running_mean": jnp.asarray(
                     0.1 * rng.randn(n).astype(np.float32)),
                 "fc.0.running_var": jnp.asarray(
                     rng.rand(n).astype(np.float32) + 0.5)}
    return params, stats


def _obs(channels, seed, t=T, b=B):
    rng = np.random.RandomState(seed)
    obs = rng.randint(0, 256, size=(t, b, HW, HW, channels)).astype(np.uint8)
    done = rng.rand(t, b) < 0.3
    done[0, 0] = True
    return obs, done


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_init_matches_jax_draw_for_draw(channels, batch_norm):
    want = jpolicy.init_conv_policy_params(
        np.random.RandomState(5), (HW, HW, channels), ACTIONS,
        batch_norm=batch_norm)
    got = policy.init_conv_policy_params(
        np.random.RandomState(5), (HW, HW, channels), ACTIONS,
        batch_norm=batch_norm, device="cpu")
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key, value in _port(w).items():
            assert g[key].dtype == torch.float32
            torch.testing.assert_close(g[key], value, atol=0, rtol=0)
    # 64 -> 2 after five stride-2 convs: 32 x 2 x 2 per frame
    assert got[0]["fc.1.weight" if batch_norm else "fc.0.weight"].shape == \
        (policy.HIDDEN, 128 * (channels // 3))


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_apply_conv_policy_outputs_and_grads_match_jax(channels, batch_norm,
                                                       train):
    params, stats = _params(channels, batch_norm)
    obs, done = _obs(channels, seed=3)
    rng = np.random.RandomState(4)
    state = tuple(0.5 * rng.randn(2, B, policy.HIDDEN).astype(np.float32)
                  for _ in range(2))
    w_logits = rng.randn(T, B, ACTIONS).astype(np.float32)
    w_base = rng.randn(T, B).astype(np.float32)

    def jax_objective(p):
        out, (h, c), new_stats = jpolicy.apply_conv_policy(
            p, stats, dict(obs=obs, done=done), state,
            batch_norm=batch_norm, train=train,
            rng=jax.random.PRNGKey(0) if train else None)
        value = (jnp.sum(out["policy_logits"] * w_logits)
                 + jnp.sum(out["baseline"] * w_base))
        return value, (out, h, c, new_stats)

    (want_value, (want_out, want_h, want_c, want_stats)), want_grads = \
        jax.value_and_grad(jax_objective, has_aux=True)(params)

    tparams = {k: v.requires_grad_() for k, v in _port(params).items()}
    out, (h, c), new_stats = policy.apply_conv_policy(
        tparams, _port(stats),
        dict(obs=torch.from_numpy(obs), done=torch.from_numpy(done)),
        tuple(torch.from_numpy(s) for s in state), batch_norm=batch_norm,
        train=train,
        generator=torch.Generator().manual_seed(0) if train else None)
    value = (torch.sum(out["policy_logits"] * torch.from_numpy(w_logits))
             + torch.sum(out["baseline"] * torch.from_numpy(w_base)))
    grads = dict(zip(tparams, torch.autograd.grad(value,
                                                  list(tparams.values()))))

    np.testing.assert_allclose(value.item(), float(want_value), rtol=TOL)
    for key in ("policy_logits", "baseline"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(want_out[key]), atol=TOL,
                                   rtol=TOL, err_msg=key)
    for got, want in ((h, want_h), (c, want_c)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
    want_grads = _port(want_grads)
    assert set(grads) == set(want_grads)
    for key, want in want_grads.items():
        np.testing.assert_allclose(grads[key].numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=key)
    for key, want in want_stats.items():
        np.testing.assert_allclose(new_stats[key].numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=key)
    if not train:
        np.testing.assert_array_equal(out["action"].numpy(),
                                      np.asarray(want_out["action"]))


@pytest.mark.parametrize("batch_norm", [False, True])
def test_one_train_step_matches_jax(batch_norm):
    """One step from the same state on the same uint8 unrolls: the loss,
    the pre-clip gradient norm, and the updated params (so the clipped
    gradients the update used) at 1e-4."""
    flags = default_flags(batch_norm=batch_norm)
    rng = np.random.RandomState(6)
    n = 40
    data = dict(obs=rng.randint(0, 256, size=(n, HW, HW, 3)).astype(np.uint8),
                action=rng.randint(0, ACTIONS, size=n).astype(np.int32),
                done=rng.rand(n) < 0.1)
    starts = np.array([3, 21])

    def fresh(module, **kw):
        return module.create_train_state(
            np.random.RandomState(2), (HW, HW, 3), ACTIONS, flags,
            conv_policy=True, max_epochs=10, seed=3, **kw)

    jstate, jopt = fresh(jbc_step)
    jstep = jbc_step.make_train_step_fused_gather(
        jopt, T, batch_norm=batch_norm, conv_policy=True, donate=False)
    jstate, want = jstep(jstate, {k: jnp.asarray(v) for k, v in data.items()},
                         jnp.asarray(starts, jnp.int32))
    state, opt = fresh(bc_step, device="cpu")
    step = bc_step.make_train_step(opt, batch_norm=batch_norm,
                                   conv_policy=True)
    batch = sampler.gather_unrolls(sampler.to_tensors(data, "cpu"), starts, T)
    assert batch["obs"].dtype == torch.uint8
    state, got = step(state, batch)
    for key in ("loss", "gradient_norm"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=GRAD_TOL, err_msg=key)
    for key, value in convert.params_to_numpy(state.params).items():
        np.testing.assert_allclose(value, np.asarray(jstate.params[key]),
                                   atol=GRAD_TOL, err_msg=key)


def test_policy_runner_on_raw_frames_matches_jax():
    params, stats = _params(3, False, seed=7)
    jrunner = jevaluate.PolicyRunner(params, stats, conv_policy=True)
    runner = evaluate.PolicyRunner(_port(params), _port(stats),
                                   conv_policy=True)
    jstate, state = jrunner.initial_state(2), runner.initial_state(2)
    for t in range(4):
        obs, _ = _obs(3, seed=10 + t, t=1)
        env_output = dict(obs=obs, done=np.array([[t == 2, False]]))
        want, jstate = jrunner(env_output, jstate)
        got, state = runner(env_output, state)
        np.testing.assert_array_equal(got["action"], want["action"])
    np.testing.assert_allclose(state[0].numpy(), np.asarray(jstate[0]),
                               atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A raw FakePointNav trajectory pickle written by the JAX datagen."""
    path = tmp_path_factory.mktemp("finetune")
    fl = jdatagen.build_tool_parser().parse_args(
        ["--env", ENV, "--save_path", str(path), "--n_trajectories", "3",
         "--max_episode_steps", "40"])
    jdatagen.gen_data_habitat(fl)
    return path


def _flags(workdir, save, **kw):
    base = dict(env=ENV, to_env=ENV, data_path=str(workdir),
                save_path=os.path.join(str(workdir), save),
                embedding_name="random", batch_size=4, unroll_length=10,
                max_frames=4 * 10 * 4, eval_frequency=2, n_episodes_test=2,
                max_episode_steps=10, debug=True, disable_cuda=True)
    base.update(kw)
    return default_flags(**base)


@pytest.mark.parametrize("eval_batch", [1, 2])
def test_finetune_run_matches_jax(workdir, eval_batch):
    want = jbc.run(_flags(workdir, f"jax_{eval_batch}",
                          eval_batch=eval_batch), mode="finetune")
    got = main_bc_finetune.run(_flags(workdir, f"port_{eval_batch}",
                                      eval_batch=eval_batch))
    g, w = got[ENV], want[ENV]
    assert set(g) == set(w)
    assert g["frames"] == w["frames"] == [0, 40, 120]
    for key in ("training_loss", "gradient_norm"):
        np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL,
                                   err_msg=key)
        assert np.isfinite(g[key][1:]).all()
    for key in ("episode_return", "episode_success"):
        assert g[key] == w[key], key
    port_dir = os.path.join(str(workdir), f"port_{eval_batch}")
    assert sorted(os.listdir(port_dir)) == [STEM + ".pickle", STEM + ".tar"]
    payload = ckpt.load_checkpoint(os.path.join(port_dir, STEM + ".tar"))
    jpayload = jckpt.load_checkpoint(os.path.join(
        str(workdir), f"jax_{eval_batch}", STEM + ".tar"))
    assert set(payload) == set(jpayload)
    assert "embedding_model_state_dict" not in payload
    actor = payload["actor_model_state_dict"]
    assert actor["feat_extract.0.weight"].shape == (3, 3, 3, 32)  # HWIO
    for key, value in jpayload["actor_model_state_dict"].items():
        np.testing.assert_allclose(actor[key], value, atol=1e-4,
                                   err_msg=key)


def test_finetune_cli_subprocess(workdir, tmp_path):
    save = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "pvr_habitat_tpu_torch.main_bc_finetune",
         "--env", ENV, "--to_env", ENV, "--data_path", str(workdir),
         "--save_path", str(save), "--batch_size", "4", "--unroll_length",
         "10", "--max_frames", "80", "--eval_frequency", "2",
         "--n_episodes_test", "1", "--max_episode_steps", "10", "--debug",
         "--disable_cuda"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "embedding: random_finetuned" in proc.stdout
    assert sorted(os.listdir(save)) == [STEM + ".pickle", STEM + ".tar"]
