"""Rollout adapter (a copy of ``pvr_habitat_tpu/envs/environment.py``;
reference: src/env_utils.py:9-81) — numpy edition.

Formats observations as (1, 1, ...) arrays, tracks episode
return/success/step, auto-randomize+reset on done.
"""

import numpy as np

from pvr_habitat_tpu_torch.envs.make_env import make_gym_env


def _format_observation(obs):
    obs = np.squeeze(np.asarray(obs))
    return obs.reshape((1, 1) + obs.shape)


def make_environment(flags, embedding_model=None, actor_id=1):
    seed = (flags.run_id + 1) * (actor_id + 1)
    gym_env = make_gym_env(flags, embedding_model, seed)
    return Environment(gym_env)


class Environment:
    def __init__(self, gym_env):
        self.gym_env = gym_env
        self.episode_return = None
        self.episode_success = None
        self.episode_step = None

    def initial(self):
        self.episode_return = np.zeros((1, 1), np.float32)
        self.episode_success = np.zeros((1, 1), np.float32)
        self.episode_step = np.zeros((1, 1), np.int32)
        self.gym_env.randomize()
        initial_obs = _format_observation(self.gym_env.reset())
        return dict(
            obs=initial_obs,
            reward=np.zeros((1, 1), np.float32),
            done=np.zeros((1, 1), bool),
            episode_return=self.episode_return,
            episode_success=self.episode_success,
            episode_step=self.episode_step,
        )

    def step(self, action):
        action = int(np.asarray(action).reshape(-1)[0])
        obs, reward, done, info = self.gym_env.step(action)

        self.episode_step = self.episode_step + 1
        episode_step = self.episode_step
        self.episode_return = self.episode_return + reward
        self.episode_success = self.episode_success + info["success"]
        episode_return = self.episode_return
        episode_success = self.episode_success

        if done:
            self.gym_env.randomize()
            obs = self.gym_env.reset()
            self.episode_return = np.zeros((1, 1), np.float32)
            self.episode_success = np.zeros((1, 1), np.float32)
            self.episode_step = np.zeros((1, 1), np.int32)

        return dict(
            obs=_format_observation(obs),
            reward=np.full((1, 1), reward, np.float32),
            done=np.full((1, 1), done, bool),
            episode_return=episode_return,
            episode_success=episode_success,
            episode_step=episode_step,
        )

    def close(self):
        self.gym_env.close()
