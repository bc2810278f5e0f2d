"""Gym-based environments (optional dependency; a copy of
``pvr_habitat_tpu/envs/gym_adapter.py``): Atari with lives/FIRE/no-op
handling, MiniGrid dict-obs unwrap, and a default pixel-observation
wrapper (reference: src/gym_wrappers.py:67-138, 293-342).  ``gym`` and
``gym_minigrid`` are imported only when an env is made."""

import numpy as np

from pvr_habitat_tpu_torch.envs import api


class AtariWrapper(api.Wrapper):
    """Atari lives/FIRE/no-op handling (reference:
    src/gym_wrappers.py:293-342).

    Documented fix (as in the JAX package, PARITY.md): the reference's ``reset`` leaves
    ``obs`` unbound when ``_real_reset`` is false (a soft reset after a
    life loss) and would raise UnboundLocalError; latent there because
    its rollout loop only resets on episode end (``_real_reset`` true).
    Here a soft reset returns the last observation from ``step``.
    """

    def __init__(self, env):
        super().__init__(env)
        self._max_lives = env.unwrapped.ale.lives()
        self._lives = self._max_lives
        self._force_fire = None
        self._real_reset = True
        self._max_no_op_actions = 30
        self._current_no_op = None
        self._last_obs = None
        assert env.unwrapped.get_action_meanings()[0] == "NOOP"

    def reset(self):
        if self._real_reset:
            obs = self.env.reset()
            self._lives = self._max_lives
        else:
            obs = self._last_obs
        self._force_fire = \
            self.env.unwrapped.get_action_meanings()[1] == "FIRE"
        self._current_no_op = np.random.randint(self._max_no_op_actions + 1)
        return np.asarray(obs)

    def step(self, action):
        if self._force_fire:
            obs, _, _, _ = self.env.step(1)
            self._force_fire = False
        while self._current_no_op > 0:
            obs, _, _, _ = self.env.step(0)
            self._current_no_op -= 1

        obs, reward, absorbing, info = self.env.step(action)
        self._real_reset = absorbing
        if info["ale.lives"] != self._lives:
            self._lives = info["ale.lives"]
            self._force_fire = \
                self.env.unwrapped.get_action_meanings()[1] == "FIRE"
        self._last_obs = obs
        info = dict(info)
        info["success"] = 0.0
        return np.asarray(obs), reward, absorbing, info


class MiniGridWrapper(api.Wrapper):
    def __init__(self, env):
        super().__init__(env)
        self.observation_space = env.observation_space.spaces["image"]

    def reset(self):
        return np.asarray(self.env.reset()["image"])

    def step(self, action):
        obs, rwd, done, info = self.env.step(action)
        info = dict(info)
        info["success"] = float(rwd > 0.0)
        return np.asarray(obs["image"]), rwd, done, info


class DefaultWrapper(api.Wrapper):
    def __init__(self, env):
        super().__init__(env)
        self.observation_space = env.observation_space.spaces["pixels"]

    def reset(self):
        return np.asarray(self.env.reset()["pixels"])

    def step(self, action):
        obs, rwd, done, info = self.env.step(action)
        info = dict(info)
        info["success"] = 0.0
        return np.asarray(obs["pixels"]), rwd, done, info


def make_gym_adapter(env_name):
    import gym  # optional dependency

    if "Atari" in env_name:
        env = gym.make(env_name.split("Atari-")[-1])
        return AtariWrapper(env)
    if "MiniGrid" in env_name:
        import gym_minigrid  # noqa: F401

        return MiniGridWrapper(gym.make(env_name))
    from gym.wrappers.pixel_observation import PixelObservationWrapper

    return DefaultWrapper(PixelObservationWrapper(gym.make(env_name)))
