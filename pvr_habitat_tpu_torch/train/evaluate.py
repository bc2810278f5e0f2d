"""Online evaluation (counterpart of ``pvr_habitat_tpu/train/evaluate.py``;
reference: src/test_model.py:4-22).

The latency-sensitive path: per simulator step the encoder runs (inside
``EmbeddingWrapper``, or inside ``FusedPolicyRunner.tick``) and then one
policy step, batch 1 or K lockstep envs.  ``PolicyRunner`` carries the
LSTM state across steps on the policy's device; each step uploads the
observation and downloads the actions once.
"""

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import policy as policy_mod


class PolicyRunner:
    """Frozen eval-mode policy (the reference's ``test_model``).

    ``sample=True`` selects actions by multinomial sampling from a
    ``torch.Generator`` seeded with ``sample_seed`` instead of argmax (the
    reference's train-mode rule, src/models.py:78-82), while keeping
    BatchNorm in eval mode — the stochastic-eval A/B knob.  ``conv_policy``
    takes raw frames (the finetune path's policy)."""

    def __init__(self, params, batch_stats=None, *, batch_norm=False,
                 conv_policy=False, sample=False, sample_seed=0):
        self.params = params
        self.batch_stats = batch_stats or {}
        self.batch_norm = batch_norm
        self.apply_fn = (policy_mod.apply_conv_policy if conv_policy
                         else policy_mod.apply_policy)
        self.device = next(iter(params.values())).device
        self.generator = None
        if sample:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(sample_seed)

    def initial_state(self, batch_size=1):
        return policy_mod.initial_state(batch_size, self.device)

    @torch.inference_mode()
    def step(self, obs, done, core_state):
        """obs (1, K, O) embeddings, or (1, K, H, W, C) raw frames for the
        conv policy, and done (1, K): tensors on the policy's device ->
        (actions (1, K) tensor, new core state)."""
        outputs, new_state, _ = self.apply_fn(
            self.params, self.batch_stats, dict(obs=obs, done=done),
            core_state, batch_norm=self.batch_norm, train=False)
        if self.generator is None:
            return outputs["action"], new_state
        logits = outputs["policy_logits"]
        action = torch.multinomial(
            torch.softmax(logits.reshape(-1, logits.shape[-1]), dim=-1), 1,
            generator=self.generator)
        return action.reshape(logits.shape[:2]), new_state

    def __call__(self, env_output, core_state):
        obs = torch.as_tensor(np.asarray(env_output["obs"])).to(self.device)
        done = torch.as_tensor(np.asarray(env_output["done"])).to(self.device)
        action, new_state = self.step(obs, done, core_state)
        return dict(action=action.cpu().numpy()), new_state


class FusedPolicyRunner:
    """One call per simulator tick: uint8 frames -> preprocess -> frozen
    encoder -> policy LSTM -> actions for K lockstep envs, all on the
    device, with one upload of the frames and one download of the
    actions (the JAX package's single-dispatch tick).

    For ImageNav the goal embeddings are cached between ticks (see
    ``tick``)."""

    def __init__(self, policy_runner, embedding):
        assert embedding.handle.preprocess is not None, \
            "true_state has no frames"
        self.policy = policy_runner
        self.embedding = embedding
        self._goal_emb = None

    def initial_state(self, batch_size=1):
        self._goal_emb = None
        return self.policy.initial_state(batch_size)

    def _embed(self, frames):
        x = torch.as_tensor(frames).to(self.embedding.device)
        return self.embedding.apply(self.embedding.params, x)

    @torch.inference_mode()
    def tick(self, frames, done, core_state, n_frames=1):
        """frames: (K*n_frames, H, W, 3) uint8, env-major frame order;
        done: (1, K).  Returns (actions (K,), new_core_state).

        For ImageNav (n_frames=2, frame order [obs_i, goal_i]...), goal
        embeddings are cached between ticks and recomputed only on
        ticks where any env restarted (goals change only via the
        auto-randomize on done) — exact, and halves steady-state
        encoder work."""
        done = np.asarray(done)
        frames = np.asarray(frames)
        k = done.shape[1]
        if n_frames == 2:
            if self._goal_emb is None or done.any():
                emb = self._embed(frames).reshape(k, 2, -1)  # env-major
                self._goal_emb = emb[:, 1]
                obs = emb.reshape(1, k, -1)
            else:
                obs_frames = frames.reshape(-1, 2, *frames.shape[1:])[:, 0]
                obs = torch.cat([self._embed(obs_frames), self._goal_emb],
                                dim=-1).reshape(1, k, -1)
        else:
            obs = self._embed(frames).reshape(1, k, -1)
        done_t = torch.as_tensor(done).to(self.policy.device)
        action, new_state = self.policy.step(obs, done_t, core_state)
        return action.cpu().numpy().reshape(-1), new_state


def _episode_quotas(n_episodes, k):
    """Fixed per-env episode quotas: env i contributes exactly
    n_episodes // k (+1 for the first n_episodes % k envs) — see the
    accounting note in ``batched_test``."""
    return [n_episodes // k + (1 if i < n_episodes % k else 0)
            for i in range(k)]


def batched_test_fused(fused_runner, raw_envs, stat_keys, n_episodes=100):
    """``batched_test`` on envs that return RAW frames: one
    ``FusedPolicyRunner.tick`` per simulator step embeds all K envs'
    frames and steps the policy.  Same per-env episode quotas."""
    k = len(raw_envs)
    outs = [env.initial() for env in raw_envs]
    core_state = fused_runner.initial_state(batch_size=k)
    stats = {key: [] for key in stat_keys}
    quotas = _episode_quotas(n_episodes, k)
    counted = [0] * k
    n_frames = np.asarray(outs[0]["obs"]).shape[-1] // 3
    while sum(counted) < n_episodes:
        frames = []
        for out in outs:
            img = np.asarray(out["obs"])[0, 0]
            frames.extend(np.split(img, n_frames, axis=-1))
        done = np.concatenate([o["done"] for o in outs], axis=1)
        actions, core_state = fused_runner.tick(np.stack(frames), done,
                                                core_state,
                                                n_frames=n_frames)
        for i, env in enumerate(raw_envs):
            outs[i] = env.step(actions[i])
            if outs[i]["done"] and counted[i] < quotas[i]:
                for key in stat_keys:
                    stats[key].append(float(np.asarray(outs[i][key])[0][0]))
                counted[i] += 1
    return stats


def batched_test(model, envs, stat_keys, n_episodes=100):
    """Vectorized evaluation: step K env instances in lockstep with one
    (1, K, ...) policy step per simulator tick.

    Episode accounting uses PER-ENV QUOTAS: env i contributes exactly
    ``n_episodes // K`` (+1 for the first ``n_episodes % K`` envs)
    completed episodes.  Counting the first n completions across the
    lockstep pool instead would over-sample short episodes relative to
    the sequential reference protocol; with fixed quotas each env's
    episode stream is i.i.d. fresh randomized episodes, so the estimator
    matches the sequential one.  An env past its quota keeps stepping
    (the lockstep batch needs an action for every lane) but its stats
    are discarded.
    """
    k = len(envs)
    outs = [env.initial() for env in envs]
    agent_state = model.initial_state(batch_size=k)
    stats = {key: [] for key in stat_keys}
    quotas = _episode_quotas(n_episodes, k)
    counted = [0] * k
    while sum(counted) < n_episodes:
        obs = np.concatenate([o["obs"] for o in outs], axis=1)
        done = np.concatenate([o["done"] for o in outs], axis=1)
        agent_output, agent_state = model(dict(obs=obs, done=done),
                                          agent_state)
        actions = np.asarray(agent_output["action"]).reshape(-1)
        for i, env in enumerate(envs):
            outs[i] = env.step(actions[i])
            if outs[i]["done"] and counted[i] < quotas[i]:
                for key in stat_keys:
                    stats[key].append(float(np.asarray(outs[i][key])[0][0]))
                counted[i] += 1
    return stats


def test(model, env, stat_keys, n_episodes=100):
    """Greedy rollouts; returns {stat: [per-episode values]}
    (reference: src/test_model.py)."""
    env_output = env.initial()
    agent_state = model.initial_state(batch_size=1)
    stats = {k: [] for k in stat_keys}
    for _ in range(n_episodes):
        while True:
            agent_output, agent_state = model(env_output, agent_state)
            env_output = env.step(agent_output["action"])
            if env_output["done"]:
                break
        for k in stat_keys:
            stats[k].append(float(np.asarray(env_output[k])[0][0]))
    return stats
