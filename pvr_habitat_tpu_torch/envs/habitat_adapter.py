"""Habitat-sim adapter (optional external dependency; a copy of
``pvr_habitat_tpu/envs/habitat_adapter.py``).

Habitat is a host-side CPU simulator feeding the card's inference path;
every habitat import sits inside a function.  This adapter exposes
habitat-lab's NavRLEnv through the same surface as FakeNavSim so the
NavigationWrapper / data-gen / eval stack is simulator-agnostic.

Task geometry mirrors the reference's habitat_config/nav_task.yaml:
64x64 RGB, HFOV 79, camera at (0, 0.88, 0), forward 0.25 m, turn 10
deg, success distance 0.2, 500 max steps, POINTGOAL_WITH_GPS_COMPASS
polar sensor, DISTANCE_TO_GOAL/SUCCESS/SPL measurements.  The config is
built programmatically (no YAML) with dataset paths resolved relative
to ``scenes_dir``.
"""

import os

import numpy as np

TASK_SETTINGS = dict(
    max_episode_steps=500,
    rgb_width=64,
    rgb_height=64,
    hfov=79,
    camera_position=(0.0, 0.88, 0.0),
    forward_step=0.25,
    turn_angle=10,
    success_distance=0.2,
)


def _build_config(scene, scenes_dir, data_path):
    from habitat_baselines.config.default import get_config

    config = get_config()
    config.defrost()
    config.ENV_NAME = "NavRLEnv"
    task = config.TASK_CONFIG
    task.ENVIRONMENT.MAX_EPISODE_STEPS = TASK_SETTINGS["max_episode_steps"]
    sim = task.SIMULATOR
    sim.RGB_SENSOR.WIDTH = TASK_SETTINGS["rgb_width"]
    sim.RGB_SENSOR.HEIGHT = TASK_SETTINGS["rgb_height"]
    sim.RGB_SENSOR.HFOV = TASK_SETTINGS["hfov"]
    sim.RGB_SENSOR.POSITION = list(TASK_SETTINGS["camera_position"])
    sim.ACTION_SPACE_CONFIG = "v0"
    sim.FORWARD_STEP_SIZE = TASK_SETTINGS["forward_step"]
    sim.TURN_ANGLE = TASK_SETTINGS["turn_angle"]
    task.TASK.TYPE = "Nav-v0"
    task.TASK.SUCCESS_DISTANCE = TASK_SETTINGS["success_distance"]
    task.TASK.SUCCESS.SUCCESS_DISTANCE = TASK_SETTINGS["success_distance"]
    task.TASK.SENSORS = ["POINTGOAL_WITH_GPS_COMPASS_SENSOR"]
    task.TASK.POINTGOAL_WITH_GPS_COMPASS_SENSOR.GOAL_FORMAT = "POLAR"
    task.TASK.POINTGOAL_WITH_GPS_COMPASS_SENSOR.DIMENSIONALITY = 2
    task.TASK.GOAL_SENSOR_UUID = "pointgoal_with_gps_compass"
    task.TASK.MEASUREMENTS = ["DISTANCE_TO_GOAL", "SUCCESS", "SPL"]
    task.DATASET.TYPE = "PointNav-v1"
    task.DATASET.SPLIT = "train"
    task.DATASET.CONTENT_SCENES = ["*"]
    task.DATASET.DATA_PATH = data_path
    task.DATASET.SCENES_DIR = os.path.join(scenes_dir, scene)
    config.freeze()
    return config


class HabitatSimAdapter:
    """FakeNavSim-compatible surface over habitat-lab's NavRLEnv."""

    action_count = 4  # STOP, FORWARD, LEFT, RIGHT

    def __init__(self, scene, seed=0, scenes_dir="Replica-Dataset/replica-path/",
                 data_path="habitat_config/replica_{split}.json.gz"):
        from habitat_baselines.common.environments import get_env_class
        from habitat_baselines.utils.env_utils import make_env_fn

        config = _build_config(scene, scenes_dir, data_path)
        env_class = get_env_class(config.ENV_NAME)
        self._env = make_env_fn(env_class=env_class, config=config)
        self._env.seed(seed)
        self.max_episode_steps = TASK_SETTINGS["max_episode_steps"]
        self.success_distance = TASK_SETTINGS["success_distance"]
        self.success_reward = float(
            self._env._rl_config.SUCCESS_REWARD)
        self._rng = np.random.RandomState(seed)

    # episode dataset handles (the reference mutates episode 0 in place,
    # src/gym_wrappers.py:259,273-274)
    @property
    def _episode(self):
        return self._env._env._dataset.episodes[0]

    @property
    def start_position(self):
        return np.asarray(self._episode.start_position, np.float32)

    @property
    def goal_position(self):
        return np.asarray(self._episode.goals[0].position, np.float32)

    def set_episode(self, start_position, start_rotation_heading,
                    goal_position):
        heading = float(start_rotation_heading)
        self._episode.start_position = list(np.asarray(start_position))
        self._episode.start_rotation = [
            0.0, float(np.sin(heading / 2)), 0.0, float(np.cos(heading / 2))]
        self._episode.goals[0].position = list(np.asarray(goal_position))

    def sample_navigable_point(self):
        return np.asarray(self._env._env.sim.sample_navigable_point(),
                          np.float32)

    def geodesic_distance(self, pos, goal=None):
        goal = self.goal_position if goal is None else goal
        return float(self._env._env.sim.geodesic_distance(
            np.asarray(pos, np.float32), np.asarray(goal, np.float32)))

    def is_navigable(self, pos):
        return bool(self._env._env.sim.is_navigable(np.asarray(pos)))

    def get_agent_state(self):
        import quaternion

        state = self._env._env.sim.get_agent_state()
        return (np.asarray(state.position, np.float32),
                quaternion.as_float_array(state.rotation).astype(np.float32))

    def get_observations_at(self, position, rotation=None, heading=None):
        if rotation is None:
            rotation = [0.0, float(np.sin(heading / 2)), 0.0,
                        float(np.cos(heading / 2))]
        return self._env._env.sim.get_observations_at(
            np.asarray(position), rotation)

    def reset(self):
        return self._env.reset()

    def step(self, action):
        obs, reward, done, info = self._env.step(**{"action": int(action)})
        info = dict(info)
        info["success"] = float(info.get("success", 0.0))
        return obs, reward, done, info

    def shortest_path_actions(self, max_steps=None):
        """habitat's greedy geodesic follower
        (reference: save_opt_trajectories.py:40-49)."""
        from habitat.datasets.utils import get_action_shortest_path
        from habitat_sim.errors import GreedyFollowerError

        try:
            path = get_action_shortest_path(
                self._env._env.sim,
                source_position=self._episode.start_position,
                source_rotation=self._episode.start_rotation,
                goal_position=self._episode.goals[0].position,
                success_distance=self.success_distance,
                max_episode_steps=max_steps or self.max_episode_steps,
            )
        except GreedyFollowerError:
            return None
        return [p.action for p in path]

    def close(self):
        self._env.close()


def make_habitat_sim(scene, seed=0, **kwargs):
    return HabitatSimAdapter(scene, seed=seed, **kwargs)
