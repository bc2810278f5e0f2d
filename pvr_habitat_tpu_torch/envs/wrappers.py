"""Environment wrapper stack (a copy of ``pvr_habitat_tpu/envs/wrappers.py``;
``EmbeddingWrapper`` calls the port's ``EmbeddingNet``, which returns
numpy in eval mode).

``NavigationWrapper`` replicates the reference's
``HabitatNavigationWrapper`` semantics (src/gym_wrappers.py:146-285)
over any simulator exposing the FakeNavSim surface: STOP-action
removal with the action+1 shift, reward normalization by
SUCCESS_REWARD, scene-id encoding, 12-d true state,
ImageNav goal-image channel concat, randomize_goal/randomize_start with
the geodesic/euclid compatibility check and retry-until-valid loop.

``EmbeddingWrapper`` (src/embeddings.py:409-444) and ``FrameStack``
(src/gym_wrappers.py:351-396) complete the stack.
"""

import re
from collections import deque

import numpy as np

from pvr_habitat_tpu_torch.envs import api

GEO_TO_EUCLID_RATIO = {
    "easy": 0.8,
    "medium": 1.0,
    "hard": 1.2,
    "random": 1.1,  # habitat default
}

SCENE_TO_ID = {
    "apartment": 0.0,
    "frl_apartment": 1.0,
    "room": 2.0,
    "office": 3.0,
    "hotel": 4.0,
}


def _is_compatible_episode(source, target, sim, near_dist=1.0, far_dist=30.0,
                           geodesic_to_euclid_ratio=1.1):
    """habitat pointnav_generator.is_compatible_episode semantics."""
    geo = sim.geodesic_distance(source, target)
    if not np.isfinite(geo) or not (near_dist <= geo <= far_dist):
        return False
    euclid = float(np.linalg.norm(
        np.asarray(source, np.float32) - np.asarray(target, np.float32)))
    return geo / max(euclid, 1e-6) >= geodesic_to_euclid_ratio


def sample_start(sim, target_position, number_retries=100,
                 difficulty="random"):
    """Retry-sampled episode start (src/gym_wrappers.py:146-167)."""
    ratio = GEO_TO_EUCLID_RATIO[difficulty]
    for _ in range(number_retries):
        source = sim.sample_navigable_point()
        if _is_compatible_episode(source, target_position, sim,
                                  geodesic_to_euclid_ratio=ratio):
            return source
    raise ValueError("Cannot find a goal position.")


class NavigationWrapper(api.Env):
    def __init__(self, sim, scene, image_goal=False, true_state=False,
                 seed=0):
        self.sim = sim
        self.action_space = api.Discrete(sim.action_count - 1)  # no STOP
        obs_shape = (64, 64, 3)
        self.observation_space = api.Box(0.0, 255.0, obs_shape, np.uint8)

        scene_name, scene_version = re.split(r"_(\d+)", scene)[:2]
        self._scene_id = SCENE_TO_ID[scene_name]
        self._scene_version = float(scene_version)

        self._true_state = None
        self.use_true_state = true_state
        self._rng = np.random.RandomState(seed)

        self.image_goal = None
        if image_goal:
            self.observation_space = api.Box(
                0.0, 255.0, (obs_shape[0], obs_shape[1], obs_shape[2] * 2),
                np.uint8)
            self.randomize_goal()
        if true_state:
            self.observation_space = api.Box(
                -np.inf, np.inf, self.get_true_state().shape, np.float32)

    @property
    def unwrapped(self):
        return self

    def seed(self, seed=0):
        self._rng = np.random.RandomState(seed)

    def get_true_state(self):
        position, rotation = self.sim.get_agent_state()
        return np.concatenate((
            np.asarray(position, np.float32),
            np.asarray(rotation, np.float32),
            np.asarray(self.sim.goal_position, np.float32),
            [self._scene_id],
            [self._scene_version],
        )).astype(np.float32)

    def _observe(self, rgb):
        self._true_state = self.get_true_state()
        if self.use_true_state:
            return self._true_state
        if self.image_goal is not None:
            return np.concatenate((rgb, self.image_goal), axis=-1)
        return rgb

    def reset(self):
        obs = self.sim.reset()
        return self._observe(np.asarray(obs["rgb"]))

    def step(self, action):
        # STOP removed: agent actions are 0=fwd, 1=left, 2=right -> +1.
        obs, rwd, done, info = self.sim.step(int(action) + 1)
        rwd /= self.sim.success_reward  # normalize rewards
        return self._observe(np.asarray(obs["rgb"])), rwd, done, info

    def close(self):
        pass

    def _random_heading_rotation(self):
        heading = self._rng.uniform(-np.pi, np.pi)
        # the reference builds [0, sin(h/2), 0, cos(h/2)]
        rotation = [0.0, np.sin(heading / 2), 0.0, np.cos(heading / 2)]
        return heading, rotation

    def randomize_goal(self):
        location = self.sim.sample_navigable_point()
        heading, _ = self._random_heading_rotation()
        self.sim.set_episode(self.sim.start_position,
                             getattr(self.sim, "_start_heading", 0.0),
                             location)
        obs = self.sim.get_observations_at(location, heading=heading)
        self.image_goal = np.asarray(obs["rgb"])

    def randomize_start(self):
        location = sample_start(self.sim, self.sim.goal_position)
        heading, _ = self._random_heading_rotation()
        self.sim.set_episode(location, heading, self.sim.goal_position)

    def randomize(self):
        ok = False
        while not ok:
            try:
                if self.image_goal is not None:
                    self.randomize_goal()
                self.randomize_start()
                ok = True
            except ValueError:
                pass


class EmbeddingWrapper(api.Wrapper):
    """Observation -> embedding (reference: src/embeddings.py:409-444).
    Stacked frames (H, W, n*3) pass through the encoder separately."""

    def __init__(self, env, embedding):
        super().__init__(env)
        in_channels = env.observation_space.shape[2]
        assert in_channels % 3 == 0, \
            "obs shape must be (H, W, n * 3) RGB frames"
        self.n_frames = in_channels // 3
        self.embedding = embedding
        self.observation_space = api.Box(
            -np.inf, np.inf, (embedding.out_size * self.n_frames,))

    def observation(self, observation):
        frames = np.stack(np.split(observation, self.n_frames, axis=-1))
        return np.asarray(self.embedding(frames)).flatten()

    def reset(self):
        return self.observation(self.env.reset())

    def step(self, action):
        obs, rwd, done, info = self.env.step(action)
        return self.observation(obs), rwd, done, info


class FrameStack(api.Wrapper):
    """Stack the last k frames on the channel axis
    (reference: src/gym_wrappers.py:351-396)."""

    def __init__(self, env, k):
        super().__init__(env)
        self.k = k
        self.frames = deque([], maxlen=k)
        shp = env.observation_space.shape
        self.observation_space = api.Box(
            0, 255.0, shp[:-1] + (shp[-1] * k,), env.observation_space.dtype)

    def reset(self):
        obs = self.env.reset()
        for _ in range(self.k):
            self.frames.append(obs)
        return self._get_obs()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self.frames.append(obs)
        return self._get_obs(), reward, done, info

    def _get_obs(self):
        assert len(self.frames) == self.k
        return np.concatenate(list(self.frames), axis=-1)
