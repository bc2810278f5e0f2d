"""The port's gym and habitat adapters against the JAX package's, on the
stubs of the JAX package's own tests (neither gym nor habitat is
installed): the gym wrappers on the fake Atari, MiniGrid and pixel envs
of ``tests/test_gym_adapter.py`` under one ``np.random`` seed, and the
habitat adapter on the ``habitat_stub`` fixture of
``tests/test_habitat_adapter.py``.  Both are numpy code, so everything
must agree exactly."""

import sys
import types

import numpy as np
import pytest

from pvr_habitat_tpu.envs import gym_adapter as jgym
from pvr_habitat_tpu.envs import habitat_adapter as jhabitat
from pvr_habitat_tpu.envs import make_env as jmake_env
from pvr_habitat_tpu.utils import flags as jflags
from pvr_habitat_tpu_torch.envs import gym_adapter, habitat_adapter, make_env
from pvr_habitat_tpu_torch.utils import flags
from tests.test_gym_adapter import _DictObsEnv, _FakeAtariEnv
from tests.test_habitat_adapter import _Node, habitat_stub  # noqa: F401

# steps through life losses (every 3 steps), a soft reset after each and
# a real reset at the episode's end
ATARI_ACTIONS = [2, 3, 0, 2, 2, 3, 1, 2, 3, 3, 0, 2]


def _atari_run(module, seed, **env_kw):
    """A scripted episode of the Atari wrapper: every output, the actions
    the env received before each reset and step, and the no-op draws."""
    np.random.seed(seed)
    env = _FakeAtariEnv(**env_kw)
    wrapper = module.AtariWrapper(env)
    record = [("reset", wrapper.reset(), wrapper._current_no_op)]
    for action in ATARI_ACTIONS:
        lives = wrapper._lives
        obs, reward, done, info = wrapper.step(action)
        record.append(("step", obs, reward, done, info, list(env.actions),
                       wrapper._lives, wrapper._force_fire))
        if done or wrapper._lives != lives:
            record.append(("reset", wrapper.reset(),
                           wrapper._current_no_op, env.n_resets))
    return record


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("seed,env_kw", [
    (0, {}), (1, dict(lives=2, life_every=3)),
    (2, dict(lives=3, life_every=3, with_fire=False)),
    (3, dict(lives=1, life_every=5))],
    ids=["fire", "life-loss", "no-fire", "one-life"])
def test_atari_wrapper_matches_jax(seed, env_kw):
    """The same ``np.random`` seed draws the same no-op prefix in both
    packages; FIRE, the no-ops, life losses, the soft reset (the
    documented fix) and the real reset give the same outputs."""
    want = _atari_run(jgym, seed, **env_kw)
    got = _atari_run(gym_adapter, seed, **env_kw)
    _assert_records_equal(got, want)
    assert any(r[0] == "reset" and len(r) == 4 for r in got)


@pytest.mark.parametrize("wrapper,key", [("MiniGridWrapper", "image"),
                                         ("DefaultWrapper", "pixels")])
def test_dict_obs_wrappers_match_jax(wrapper, key):
    records = []
    for module in (jgym, gym_adapter):
        w = getattr(module, wrapper)(_DictObsEnv(key))
        record = [("space", w.observation_space.shape),
                  ("reset", w.reset())]
        for action in (2, 0, 1):
            record.append(("step",) + tuple(w.step(action)))
        records.append(record)
    _assert_records_equal(records[1], records[0])


def test_make_gym_adapter_routes_like_jax(monkeypatch):
    """``make_gym_adapter``: 'Atari-<id>' makes '<id>' and wraps it in the
    Atari wrapper, 'MiniGrid*' imports gym_minigrid and unwraps 'image',
    anything else goes through the pixel-observation wrapper; on a stub
    ``gym`` both packages make the same envs and wrappers."""
    made = []
    gym = types.ModuleType("gym")
    gym.make = lambda name: made.append(name) or (
        _FakeAtariEnv() if name == "Pong" else _DictObsEnv(
            "image" if name.startswith("MiniGrid") else "pixels"))
    wrappers = types.ModuleType("gym.wrappers")
    pixel = types.ModuleType("gym.wrappers.pixel_observation")
    pixel.PixelObservationWrapper = lambda env: env
    for name, mod in {"gym": gym, "gym.wrappers": wrappers,
                      "gym.wrappers.pixel_observation": pixel,
                      "gym_minigrid": types.ModuleType("gym_minigrid")
                      }.items():
        monkeypatch.setitem(sys.modules, name, mod)
    for name in ("Atari-Pong", "MiniGrid-Empty-5x5-v0", "CartPole-v1"):
        kinds = []
        for module in (jgym, gym_adapter):
            np.random.seed(0)
            env = module.make_gym_adapter(name)
            kinds.append((type(env).__name__, env.reset().shape))
        assert kinds[0] == kinds[1], name
    assert made == ["Pong", "Pong", "MiniGrid-Empty-5x5-v0",
                    "MiniGrid-Empty-5x5-v0", "CartPole-v1", "CartPole-v1"]


def _config_tree(node):
    children = object.__getattribute__(node, "_children")
    return {k: _config_tree(v) if isinstance(v, _Node) else v
            for k, v in children.items()}


def test_habitat_config_surgery_matches_jax(habitat_stub):  # noqa: F811
    """The same config, node for node, and the same env settings."""
    trees, adapters = [], []
    for module in (jhabitat, habitat_adapter):
        adapters.append(module.HabitatSimAdapter("room_0", seed=3))
        trees.append(_config_tree(habitat_stub["config"]))
        assert habitat_stub["env"].seeded_with == 3
    assert trees[0] == trees[1]
    assert trees[1]["TASK_CONFIG"]["DATASET"]["SCENES_DIR"].endswith(
        "room_0")
    assert habitat_adapter.TASK_SETTINGS == jhabitat.TASK_SETTINGS
    for attr in ("max_episode_steps", "success_distance", "success_reward",
                 "action_count"):
        assert getattr(adapters[0], attr) == getattr(adapters[1], attr)


def _adapter_run(module, habitat_stub):  # noqa: F811
    adapter = module.HabitatSimAdapter("room_0")
    episode = habitat_stub["env"]._env._dataset.episodes[0]
    record = [adapter.start_position, adapter.goal_position]
    adapter.set_episode([1.0, 0.0, 1.0], np.pi / 3, [3.0, 0.0, 2.0])
    record += [adapter.start_position, adapter.goal_position,
               np.asarray(episode.start_rotation),
               np.asarray(episode.start_position),
               np.asarray(episode.goals[0].position)]
    record += list(adapter.get_agent_state())
    record.append(adapter.get_observations_at([0, 0, 0], heading=0.3)["rgb"])
    record.append(adapter.geodesic_distance([0.0, 0.0, 0.0]))
    record.append(adapter.is_navigable([0.0, 0.0, 0.0]))
    record.append(adapter.shortest_path_actions(max_steps=7))
    record.append(dict(habitat_stub["follower_args"]))
    record.append(adapter.reset()["rgb"])
    for action in (1, 2, 3):
        obs, reward, done, info = adapter.step(action)
        record += [obs["rgb"], reward, done, info]
    return record


def test_habitat_adapter_surface_matches_jax(habitat_stub):  # noqa: F811
    """The episode mutation, the agent state, the observations, the
    follower's path and arguments, and the steps, equal."""
    want = _adapter_run(jhabitat, habitat_stub)
    got = _adapter_run(habitat_adapter, habitat_stub)
    _assert_records_equal([got], [want])


@pytest.mark.parametrize("env_name", ["HabitatImageNav-room_0",
                                      "HabitatPointNav-room_0"])
def test_make_gym_env_routes_habitat_through_the_adapter(
        habitat_stub, env_name):  # noqa: F811
    """With habitat importable, ``make_gym_env`` builds the port's
    adapter under the NavigationWrapper (no FakeNav warning), and the
    episode's observations, rewards and infos are the JAX package's."""
    import warnings

    runs = []
    for module, fl in ((jmake_env, jflags), (make_env, flags)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            env = module.make_gym_env(
                fl.default_flags(env=env_name, embedding_name="true_state"
                                 if "Point" in env_name else "resnet50"),
                None, seed=1)
        sim = env.unwrapped.sim
        record = [type(sim).__module__, env.action_space.n, env.reset()]
        for action in (0, 1, 2):
            record += list(env.step(action))
        env.close()
        runs.append(record)
    assert runs[0][0] == "pvr_habitat_tpu.envs.habitat_adapter"
    assert runs[1][0] == "pvr_habitat_tpu_torch.envs.habitat_adapter"
    _assert_records_equal([runs[1][1:]], [runs[0][1:]])
    assert runs[1][-2] is True and runs[1][-1]["success"] == 1.0
