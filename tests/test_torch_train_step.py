"""The port's train step, optimizer, sampler and checkpoints against the
JAX package's (CPU, f32): K steps from one init and one list of starts,
the host RNG stream, the unroll gather, and checkpoints read both ways."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.data import sampler as jsampler
from pvr_habitat_tpu.train import bc_step as jbc_step
from pvr_habitat_tpu.train import optim as joptim
from pvr_habitat_tpu.utils import checkpoint as jckpt
from pvr_habitat_tpu_torch.data import sampler
from pvr_habitat_tpu_torch.models import policy
from pvr_habitat_tpu_torch.train import bc_step, optim
from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
from pvr_habitat_tpu_torch.utils.flags import default_flags

METRIC_RTOL = 1e-4   # losses and pre-clip gradient norms
STATE_ATOL = 1e-4    # params and optimizer state after K steps
T, B, OBS, ACTIONS, N, K = 6, 4, 16, 3, 64, 3


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


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return dict(obs=rng.randn(N, OBS).astype(np.float32),
                action=rng.randint(0, ACTIONS, size=N).astype(np.int32),
                done=rng.rand(N) < 0.1)


def _starts(seed=1):
    # includes starts near the end, so the gather wraps around
    starts = np.random.RandomState(seed).randint(0, N, size=(K, B))
    starts[0, 0] = N - 2
    return starts


def _assert_states_close(state, jstate):
    for key, want in jstate.params.items():
        np.testing.assert_allclose(state.params[key].numpy(),
                                   np.asarray(want), atol=STATE_ATOL,
                                   err_msg=key)
    for key, want in jstate.batch_stats.items():
        np.testing.assert_allclose(state.batch_stats[key].numpy(),
                                   np.asarray(want), atol=STATE_ATOL,
                                   err_msg=key)
    assert state.opt_state.count == int(jstate.opt_state.count)
    for key, want in jstate.opt_state.square_avg.items():
        np.testing.assert_allclose(state.opt_state.square_avg[key].numpy(),
                                   np.asarray(want), atol=STATE_ATOL,
                                   err_msg=key)
    if jstate.opt_state.momentum_buf == ():
        assert state.opt_state.momentum_buf == ()
    else:
        # the buffer sums steps g / sqrt(v) of about 10 each, so it is
        # held relatively as well
        for key, want in jstate.opt_state.momentum_buf.items():
            np.testing.assert_allclose(
                state.opt_state.momentum_buf[key].numpy(), np.asarray(want),
                atol=STATE_ATOL, rtol=METRIC_RTOL, err_msg=key)


@pytest.mark.parametrize("variant", ["default", "batch_norm_momentum"])
def test_k_steps_match_jax_fused_gather_and_chunked(variant):
    flags = default_flags(batch_norm=variant != "default",
                          momentum=0.9 if variant != "default" else 0.0)
    data, starts = _data(), _starts()

    def fresh(module, **kw):
        return module.create_train_state(np.random.RandomState(2), (OBS,),
                                         ACTIONS, flags, max_epochs=10,
                                         seed=3, **kw)

    kw = dict(batch_norm=flags.batch_norm)
    jinit, jopt = fresh(jbc_step)     # not donated: both runs start here
    jstep = jbc_step.make_train_step_fused_gather(jopt, T, donate=False, **kw)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jstate, want = jinit, []
    for row in starts:
        jstate, metrics = jstep(jstate, jdata, jnp.asarray(row, jnp.int32))
        want.append((float(metrics["loss"]), float(metrics["gradient_norm"])))
    jchunk_state, jchunk_metrics = jbc_step.make_train_step_chunked(
        jopt, T, donate=False, **kw)(jinit, jdata,
                                     jnp.asarray(starts, jnp.int32))

    # the port: one step per row of starts, on the batch gathered where
    # the data lies
    tdata = sampler.to_tensors(data, "cpu")
    state, opt = fresh(bc_step, device="cpu")
    step = bc_step.make_train_step(opt, **kw)
    got = []
    for row in starts:
        state, metrics = step(state, sampler.gather_unrolls(tdata, row, T))
        assert metrics["loss"].dim() == 0 and torch.is_tensor(
            metrics["gradient_norm"])
        got.append((metrics["loss"].item(),
                    metrics["gradient_norm"].item()))
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    _assert_states_close(state, jstate)

    # JAX's chunked step over the K rows is the port's K steps; its
    # metrics are the last step's
    np.testing.assert_allclose(
        got[-1], [float(jchunk_metrics["loss"]),
                  float(jchunk_metrics["gradient_norm"])], rtol=METRIC_RTOL)
    _assert_states_close(state, jchunk_state)


# the reference steps the scheduler first, which torch warns about
@pytest.mark.filterwarnings("ignore:Detected call of `lr_scheduler.step")
def test_optimizer_and_clip_match_jax_and_torch_optim():
    """Against the JAX transform, and against torch.optim.RMSprop with
    clip_grad_norm_ and a LambdaLR stepped before the optimizer (the
    reference's loop, main_bc_2.py:216-227)."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    jopt = joptim.rmsprop_torch(0.01, momentum=0.5, max_epochs=7)
    opt = optim.RMSpropTorch(0.01, momentum=0.5, max_epochs=7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = sampler.to_tensors(params, "cpu")
    ref = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    ref_opt = torch.optim.RMSprop(ref.values(), lr=0.01, alpha=0.99,
                                  eps=1e-5, momentum=0.5)
    sched = torch.optim.lr_scheduler.LambdaLR(ref_opt,
                                              lambda e: 1 - e / 7)
    jstate, state = jopt.init(jp), opt.init(tp)
    for _ in range(5):
        g = {k: (30 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in params.items()}
        jg, jnorm = joptim.clip_by_global_norm_torch(
            {k: jnp.asarray(v) for k, v in g.items()}, 40.0)
        tg, norm = optim.clip_by_global_norm_torch(
            sampler.to_tensors(g, "cpu"), 40.0)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        jupd, jstate = jopt.update(jg, jstate)
        upd, state = opt.update(tg, state)
        jp = {k: jp[k] + jupd[k] for k in jp}
        tp = optim.apply_updates(tp, upd)
        sched.step()
        for k, p in ref.items():
            p.grad = torch.tensor(g[k])
        ref_norm = torch.nn.utils.clip_grad_norm_(ref.values(), 40.0)
        np.testing.assert_allclose(norm.item(), ref_norm.item(), rtol=1e-6)
        ref_opt.step()
    for key in params:
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tp[key].numpy(),
                                   ref[key].detach().numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_sampler_stream_and_gather_match_jax():
    random.seed(11)
    want = [jsampler.sample_with_minimum_distance(n=3300, k=32, d=100)
            for _ in range(5)]
    random.seed(11)
    got = [sampler.sample_with_minimum_distance(n=3300, k=32, d=100)
           for _ in range(5)]
    assert got == want
    for starts in got:
        s = sorted(starts)
        assert all(b - a >= 100 for a, b in zip(s, s[1:]))

    data = dict(obs=np.arange(20, dtype=np.float32).reshape(10, 2),
                action=np.arange(10))
    out = sampler.gather_unrolls(sampler.to_tensors(data, "cpu"), [7, 1], 5)
    np.testing.assert_array_equal(out["action"][:, 0].numpy(),
                                  [7, 8, 9, 0, 1])
    jout = jsampler.gather_unrolls_host(data, [7, 1], 5)
    for key in data:
        np.testing.assert_array_equal(out[key].numpy(), jout[key])


def test_device_put_budget():
    data = _data()
    on, placed = sampler.maybe_device_put(data, "cpu")
    assert placed and on["obs"].dtype == torch.float32
    _, placed = sampler.maybe_device_put(data, "cpu", budget_bytes=10)
    assert not placed
    _, placed = sampler.maybe_device_put(data, "cpu", mode="never")
    assert not placed
    assert sampler.dataset_nbytes(data) == sum(v.nbytes for v in data.values())


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_checkpoints_load_both_ways(tmp_path, momentum):
    flags = default_flags(batch_norm=True, momentum=momentum)
    jstate, jopt = jbc_step.create_train_state(
        np.random.RandomState(0), (OBS,), ACTIONS, flags, max_epochs=9)
    state, _ = bc_step.create_train_state(
        np.random.RandomState(0), (OBS,), ACTIONS, flags, max_epochs=9,
        device="cpu")
    step = bc_step.make_train_step(
        optim.RMSpropTorch(1e-3, momentum=momentum, max_epochs=9),
        batch_norm=True)
    state, _ = step(state, sampler.gather_unrolls(
        sampler.to_tensors(_data(), "cpu"), _starts()[0], T))
    emb = {"conv.weight": np.ones((3, 3, 3, 4), np.float32)}

    port_path = str(tmp_path / "port.tar")
    ckpt.save_checkpoint(port_path, actor_params=state.params,
                         actor_batch_stats=state.batch_stats,
                         opt_state=state.opt_state, flags=flags,
                         embedding_state=emb)
    payload = jckpt.load_checkpoint(port_path)
    assert payload["format"] == "pvr_habitat_tpu/ckpt-v1"
    assert payload["scheduler_state_dict"] == {"last_epoch": 1}
    params, stats = jckpt.split_actor_state(payload["actor_model_state_dict"])
    opt_state = jckpt.restore_opt_state(payload)
    assert int(opt_state.count) == 1
    for key, value in state.params.items():
        np.testing.assert_array_equal(np.asarray(params[key]), value.numpy())
    for key, value in state.batch_stats.items():
        np.testing.assert_array_equal(np.asarray(stats[key]), value.numpy())
    np.testing.assert_array_equal(
        payload["embedding_model_state_dict"]["conv.weight"],
        emb["conv.weight"])

    jax_path = str(tmp_path / "jax.tar")
    jckpt.save_checkpoint(jax_path, actor_params=params,
                          actor_batch_stats=stats, opt_state=opt_state,
                          flags=flags)
    back = ckpt.load_checkpoint(jax_path)
    params2, stats2 = ckpt.split_actor_state(back["actor_model_state_dict"],
                                             "cpu")
    opt2 = ckpt.restore_opt_state(back, "cpu")
    assert opt2.count == 1
    for key, value in state.params.items():
        assert torch.equal(params2[key], value)
    for key, value in state.batch_stats.items():
        assert torch.equal(stats2[key], value)
    for key, value in state.opt_state.square_avg.items():
        assert torch.equal(opt2.square_avg[key], value)
    if momentum:
        for key, value in state.opt_state.momentum_buf.items():
            assert torch.equal(opt2.momentum_buf[key], value)
    else:
        assert opt2.momentum_buf == ()
    assert back["flags"] == payload["flags"] == vars(flags)


# Each builder of the slice, called as a user would: no device given.
BUILDERS = {
    "init_policy_params": lambda payload: policy.init_policy_params(
        np.random.RandomState(0), OBS, ACTIONS)[0],
    "initial_state": lambda payload: {"h": policy.initial_state(B)[0]},
    "create_train_state": lambda payload: bc_step.create_train_state(
        np.random.RandomState(0), (OBS,), ACTIONS, default_flags())[0].params,
    "split_actor_state": lambda payload: ckpt.split_actor_state(
        payload["actor_model_state_dict"])[0],
    "restore_opt_state": lambda payload: ckpt.restore_opt_state(
        payload).square_avg,
}


@pytest.fixture(scope="module")
def cpu_checkpoint(tmp_path_factory):
    state, _ = bc_step.create_train_state(
        np.random.RandomState(0), (OBS,), ACTIONS, default_flags(),
        device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "c.tar")
    ckpt.save_checkpoint(path, actor_params=state.params,
                         actor_batch_stats=state.batch_stats,
                         opt_state=state.opt_state, flags=default_flags())
    return ckpt.load_checkpoint(path)


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builders_default_to_cuda(cpu_checkpoint, builder):
    """Without a device the slice's builders put their tensors on ``cuda``,
    and raise where there is none, like every entry point of the port;
    the CPU is used only when asked for."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BUILDERS[builder](cpu_checkpoint)
        return
    tensors = BUILDERS[builder](cpu_checkpoint)
    assert {v.device.type for v in tensors.values()} == {"cuda"}
