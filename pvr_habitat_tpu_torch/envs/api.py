"""Minimal gym-compatible spaces/env API (gym is not a dependency; a
copy of ``pvr_habitat_tpu/envs/api.py``).

Duck-type compatible with the subset of gym the reference uses:
``observation_space.shape``, ``action_space.n``, ``reset/step/seed/
close/randomize``.
"""

import numpy as np


class Discrete:
    def __init__(self, n):
        self.n = int(n)

    def sample(self, rng=np.random):
        return int(rng.randint(self.n))

    def __repr__(self):
        return f"Discrete({self.n})"


class Box:
    def __init__(self, low, high, shape, dtype=np.float32):
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self):
        return f"Box{self.shape}"


class Env:
    """Base env with the reference's required surface."""

    observation_space = None
    action_space = None

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def seed(self, seed=0):
        pass

    def close(self):
        pass

    def randomize(self):
        pass

    def render(self, mode="rgb_array"):
        pass


class Wrapper(Env):
    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def seed(self, seed=0):
        return self.env.seed(seed)

    def close(self):
        return self.env.close()

    def randomize(self):
        return self.env.randomize()

    def __getattr__(self, name):
        return getattr(self.env, name)
