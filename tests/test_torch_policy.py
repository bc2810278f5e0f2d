"""The port's LSTM and policy against the JAX package's on the same
seeded inputs (CPU, f32): outputs and gradients at 1e-5, the numpy init
draw for draw, the BatchNorm1d running stats, and the eval runners."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.models import policy as jpolicy
from pvr_habitat_tpu.ops import lstm as jlstm
from pvr_habitat_tpu.train import evaluate as jevaluate
from pvr_habitat_tpu_torch.models import policy
from pvr_habitat_tpu_torch.ops import lstm
from pvr_habitat_tpu_torch.train import evaluate

TOL = 1e-5          # f32 parity of the policy (outputs and gradients)
T, B, OBS, ACTIONS = 4, 3, 24, 3


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


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


def _done(rng, t=T, b=B):
    done = rng.rand(t, b) < 0.3
    done[0, 0] = True           # a reset at step 0
    return done


def test_lstm_scan_matches_jax():
    rng = np.random.RandomState(0)
    t, b, n_in, hidden, layers = 6, 3, 5, 7, 2
    flat = {}
    for layer in range(layers):
        width = n_in if layer == 0 else hidden
        flat[f"c.weight_ih_l{layer}"] = rng.randn(4 * hidden, width)
        flat[f"c.weight_hh_l{layer}"] = rng.randn(4 * hidden, hidden)
        flat[f"c.bias_ih_l{layer}"] = rng.randn(4 * hidden)
        flat[f"c.bias_hh_l{layer}"] = rng.randn(4 * hidden)
    flat = {k: (0.3 * v).astype(np.float32) for k, v in flat.items()}
    x = rng.randn(t, b, n_in).astype(np.float32)
    h0 = rng.randn(layers, b, hidden).astype(np.float32)
    c0 = rng.randn(layers, b, hidden).astype(np.float32)
    notdone = 1.0 - _done(rng, t, b).astype(np.float32)

    want_y, (want_h, want_c) = jlstm.lstm_scan(
        jlstm.stack_lstm_params({k: jnp.asarray(v) for k, v in flat.items()},
                                "c", layers),
        x, h0, c0, notdone)
    got_y, (got_h, got_c) = lstm.lstm_scan(
        lstm.stack_lstm_params(_t(flat), "c", layers), torch.from_numpy(x),
        torch.from_numpy(h0), torch.from_numpy(c0),
        torch.from_numpy(notdone))
    for got, want in ((got_y, want_y), (got_h, want_h), (got_c, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    # the done at t = 0 dropped the initial state of lane 0
    fresh_y, _ = lstm.lstm_scan(
        lstm.stack_lstm_params(_t(flat), "c", layers),
        torch.from_numpy(x[:1, :1]), torch.zeros(layers, 1, hidden),
        torch.zeros(layers, 1, hidden), torch.ones(1, 1))
    np.testing.assert_allclose(got_y[0, 0].numpy(), fresh_y[0, 0].numpy(),
                               atol=1e-7)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_init_matches_jax_draw_for_draw(batch_norm):
    want = jpolicy.init_policy_params(np.random.RandomState(5), OBS, ACTIONS,
                                      batch_norm=batch_norm)
    got = policy.init_policy_params(np.random.RandomState(5), OBS, ACTIONS,
                                    batch_norm=batch_norm, device="cpu")
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == torch.float32
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    h, c = policy.initial_state(B, "cpu")
    assert h.shape == c.shape == (2, B, policy.HIDDEN) and not h.any()


def _inputs(seed):
    rng = np.random.RandomState(seed)
    obs = rng.randn(T, B, OBS).astype(np.float32)
    done = _done(rng)
    state = tuple(0.5 * rng.randn(2, B, policy.HIDDEN).astype(np.float32)
                  for _ in range(2))
    # weights of a scalar objective over both heads, for the gradients
    w_logits = rng.randn(T, B, ACTIONS).astype(np.float32)
    w_base = rng.randn(T, B).astype(np.float32)
    return obs, done, state, w_logits, w_base


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_apply_policy_outputs_and_grads_match_jax(batch_norm, train):
    params, stats = jpolicy.init_policy_params(
        np.random.RandomState(1), OBS, ACTIONS, batch_norm=batch_norm)
    if batch_norm:   # non-trivial BN parameters and running stats
        rng = np.random.RandomState(2)
        params["fc.0.weight"] = jnp.asarray(
            1 + 0.1 * rng.randn(OBS).astype(np.float32))
        params["fc.0.bias"] = jnp.asarray(0.1 * rng.randn(OBS)
                                          .astype(np.float32))
        stats = {"fc.0.running_mean": jnp.asarray(
                     rng.randn(OBS).astype(np.float32)),
                 "fc.0.running_var": jnp.asarray(
                     rng.rand(OBS).astype(np.float32) + 0.5)}
    obs, done, state, w_logits, w_base = _inputs(3)

    def jax_objective(p):
        out, (h, c), new_stats = jpolicy.apply_policy(
            p, stats, dict(obs=obs, done=done), state,
            batch_norm=batch_norm, train=train,
            rng=jax.random.PRNGKey(0) if train else None)
        value = (jnp.sum(out["policy_logits"] * w_logits)
                 + jnp.sum(out["baseline"] * w_base))
        return value, (out, h, c, new_stats)

    (want_value, (want_out, want_h, want_c, want_stats)), want_grads = \
        jax.value_and_grad(jax_objective, has_aux=True)(params)

    tparams = {k: v.requires_grad_() for k, v in _t(params).items()}
    gen = torch.Generator().manual_seed(0)
    out, (h, c), new_stats = policy.apply_policy(
        tparams, _t(stats),
        dict(obs=torch.from_numpy(obs), done=torch.from_numpy(done)),
        tuple(torch.from_numpy(s) for s in state), batch_norm=batch_norm,
        train=train, generator=gen if train else None)
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
    assert set(grads) == set(want_grads)
    for key, want in want_grads.items():
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=key)
    for key, want in want_stats.items():
        np.testing.assert_allclose(new_stats[key].numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=key)
    assert out["action"].shape == (T, B)
    if not train:
        np.testing.assert_array_equal(out["action"].numpy(),
                                      np.asarray(want_out["action"]))


def test_batch_norm_running_stats_after_one_train_call():
    """Biased variance normalises; the unbiased one moves the running
    variance (torch BatchNorm1d, momentum 0.1)."""
    params, stats = policy.init_policy_params(
        np.random.RandomState(0), OBS, ACTIONS, batch_norm=True,
        device="cpu")
    obs, done, state, _, _ = _inputs(4)
    x = torch.from_numpy(obs.reshape(T * B, OBS))
    _, _, new_stats = policy.apply_policy(
        params, stats, dict(obs=torch.from_numpy(obs),
                            done=torch.from_numpy(done)),
        policy.initial_state(B, "cpu"), batch_norm=True, train=True,
        generator=torch.Generator().manual_seed(0))
    bn = torch.nn.BatchNorm1d(OBS, momentum=0.1)
    bn.train()
    bn(x)
    np.testing.assert_allclose(new_stats["fc.0.running_mean"].numpy(),
                               bn.running_mean.numpy(), atol=1e-6)
    np.testing.assert_allclose(new_stats["fc.0.running_var"].numpy(),
                               bn.running_var.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        policy.apply_policy(params, stats, dict(obs=torch.from_numpy(obs),
                                                done=torch.from_numpy(done)),
                            policy.initial_state(B, "cpu"), batch_norm=True,
                            train=True)


def test_policy_runner_matches_jax_greedy_and_samples_reproducibly():
    params, stats = jpolicy.init_policy_params(
        np.random.RandomState(7), OBS, ACTIONS)
    jrunner = jevaluate.PolicyRunner(params, stats)
    runner = evaluate.PolicyRunner(_t(params), _t(stats))
    rng = np.random.RandomState(8)
    jstate, state = jrunner.initial_state(2), runner.initial_state(2)
    for t in range(6):
        env_output = dict(obs=rng.randn(1, 2, OBS).astype(np.float32),
                          done=np.array([[t == 3, False]]))
        want, jstate = jrunner(env_output, jstate)
        got, state = runner(env_output, state)
        assert isinstance(got["action"], np.ndarray)
        np.testing.assert_array_equal(got["action"], want["action"])
    np.testing.assert_allclose(state[0].numpy(), np.asarray(jstate[0]),
                               atol=TOL, rtol=TOL)

    def sampled(seed):
        r = evaluate.PolicyRunner(_t(params), _t(stats), sample=True,
                                  sample_seed=seed)
        s, actions = r.initial_state(2), []
        for _ in range(20):
            out, s = r(dict(obs=np.zeros((1, 2, OBS), np.float32),
                            done=np.zeros((1, 2), bool)), s)
            actions.append(out["action"])
        return np.concatenate(actions)

    assert sampled(0).shape == (20, 2)
    np.testing.assert_array_equal(sampled(0), sampled(0))
    assert not np.array_equal(sampled(0), sampled(1))
