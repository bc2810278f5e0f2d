"""The port's envs, datagen, formats, flags and stats against the JAX
package's on the same seeds (CPU).  The simulator and the wrappers are
numpy copies, so everything but the embeddings must agree exactly; the
embeddings at the 1e-3 parity contract."""

import os
import pickle
import warnings

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.envs import environment as jenvironment
from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu.tools import save_opt_trajectories as jdatagen
from pvr_habitat_tpu.utils import flags as jflags
from pvr_habitat_tpu.utils import stats as jstats
from pvr_habitat_tpu_torch.data import formats
from pvr_habitat_tpu_torch.envs import environment, make_env
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.tools import save_opt_trajectories as datagen
from pvr_habitat_tpu_torch.utils import flags, stats

EMBED_TOL = 1e-3    # the f32 parity contract (BASELINE.md)
# A fixed action sequence that turns, walks into walls and walks on.
ACTIONS = [0, 0, 1, 0, 0, 2, 2, 0, 0, 0, 1, 1, 0, 0, 0, 0, 2, 0, 0, 0]


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


def _flags(module, **kw):
    return module.default_flags(max_episode_steps=12, **kw)


def _rollout(env_module, fl, embedding=None, actor_id=1):
    env = env_module.make_environment(fl, embedding, actor_id=actor_id)
    sim = env.gym_env.unwrapped.sim
    outs = [env.initial()]
    goals = [sim.goal_position.copy()]
    for a in ACTIONS:
        outs.append(env.step(np.array([[a]])))
        goals.append(sim.goal_position.copy())
    return outs, goals


@pytest.mark.parametrize("env_name", ["FakePointNav-apartment_0",
                                      "FakeImageNav-hotel_0",
                                      "HabitatPointNav-office_1"])
def test_rollout_matches_jax_exactly(env_name):
    """obs, reward, done, episode stats and goal for a fixed action
    sequence, across an episode end (max 12 steps) and the auto-reset."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the Habitat -> FakeNav notice
        want, want_goals = _rollout(jenvironment,
                                    _flags(jflags, env=env_name))
        got, got_goals = _rollout(environment, _flags(flags, env=env_name))
    assert any(bool(o["done"]) for o in got)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert g[key].dtype == w[key].dtype, key
    np.testing.assert_array_equal(np.stack(got_goals), np.stack(want_goals))


def test_embedding_wrapper_and_framestack_match_jax():
    """EmbeddingWrapper (random encoder) under FrameStack(2): the stacked
    embeddings agree at the parity contract."""
    env_name = "FakeImageNav-room_0"
    kw = dict(env=env_name, embedding_name="random", num_input_frames=2)
    want, _ = _rollout(jenvironment, _flags(jflags, **kw),
                       JaxNet("random", pretrained=False))
    got, _ = _rollout(environment, _flags(flags, **kw),
                      EmbeddingNet("random", pretrained=False, device="cpu"))
    # ImageNav: 2 frames per obs, stacked twice -> 4 embeddings of 1568
    assert got[0]["obs"].shape == (1, 1, 4 * 1568)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["obs"], w["obs"], atol=EMBED_TOL,
                                   rtol=EMBED_TOL)
        for key in ("reward", "done", "episode_return", "episode_step"):
            np.testing.assert_array_equal(g[key], w[key])


def test_pointnav_goal_is_a_scene_property():
    """Datagen and every eval env navigate to the same goal, whatever
    their seeds (the reference pins it to the scene's first episode)."""
    fl = _flags(flags, env="FakePointNav-frl_apartment_2", run_id=3)
    datagen_env = make_env.make_gym_env(fl, seed=0)
    goal = datagen_env.unwrapped.sim.goal_position
    eval_envs = [environment.make_environment(fl, actor_id=i)
                 for i in range(1, 5)]
    for env in eval_envs:
        env.initial()
        np.testing.assert_array_equal(env.gym_env.unwrapped.sim.goal_position,
                                      goal)
    # ... while the starts differ between seeds
    starts = {tuple(env.gym_env.unwrapped.sim.start_position)
              for env in eval_envs}
    assert len(starts) > 1
    other = make_env.make_gym_env(_flags(flags, env="FakePointNav-room_2"))
    assert not np.array_equal(other.unwrapped.sim.goal_position, goal)


def test_imagenav_redraws_goals_per_episode():
    env = environment.make_environment(
        _flags(flags, env="FakeImageNav-apartment_0"))
    sim = env.gym_env.unwrapped.sim
    goals = []
    for _ in range(3):
        env.initial()
        goals.append(tuple(sim.goal_position))
    assert len(set(goals)) == 3


def test_unported_envs_raise_and_habitat_falls_back(monkeypatch):
    """Atari and MiniGrid reach the gym adapter; without habitat,
    Habitat* falls back to FakeNav with a warning; an installed habitat
    reaches its adapter (``tests/test_torch_adapters.py`` drives both
    adapters on stubs)."""
    from pvr_habitat_tpu_torch.envs import gym_adapter, habitat_adapter

    def reached(name, seed=None):
        raise LookupError(name)

    monkeypatch.setattr(gym_adapter, "make_gym_adapter", reached)
    for name in ("Atari-Pong", "MiniGrid-Empty"):
        with pytest.raises(LookupError, match=name):
            make_env.make_gym_env(_flags(flags, env=name))
    with pytest.warns(UserWarning, match="FakeNav"):
        env = make_env.make_gym_env(
            _flags(flags, env="HabitatImageNav-hotel_0"))
    assert env.observation_space.shape == (64, 64, 6)
    # an installed habitat must not be ignored quietly
    monkeypatch.setattr(make_env, "_habitat_available", lambda: True)
    monkeypatch.setattr(habitat_adapter, "make_habitat_sim", reached)
    with pytest.raises(LookupError, match="hotel_0"):
        make_env.make_gym_env(_flags(flags, env="HabitatPointNav-hotel_0"))


@pytest.mark.parametrize("env_name", ["FakePointNav-hotel_0",
                                      "FakeImageNav-apartment_0"])
def test_datagen_pickle_matches_jax(tmp_path, env_name):
    paths = {}
    for name, module in (("jax", jdatagen), ("port", datagen)):
        out = tmp_path / name
        fl = module.build_tool_parser().parse_args(
            ["--env", env_name, "--save_path", str(out),
             "--n_trajectories", "3", "--max_episode_steps", "40"])
        paths[name] = module.gen_data_habitat(fl)
    assert os.path.basename(paths["port"]) == f"{env_name}.pickle"
    want = formats.load_pickle(paths["jax"])
    got = formats.load_pickle(paths["port"])
    assert set(got) == set(want) == {"obs", "action", "reward", "done",
                                     "true_state"}
    for key in want:
        assert len(got[key]) == len(want[key]) == 3
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=key)
    merged = formats.read_habitat_data(paths["port"], verbose=False)
    assert merged["obs"].shape[0] == sum(len(a) for a in want["action"])


def test_embedded_pickle_reads_both_ways(tmp_path):
    from pvr_habitat_tpu.data import formats as jformats

    rng = np.random.RandomState(0)
    arrays = dict(obs=rng.randn(7, 5).astype(np.float32),
                  action=rng.randint(0, 3, 7), reward=rng.randn(7),
                  done=rng.rand(7) < 0.3,
                  true_state=rng.randn(7, 12).astype(np.float32))
    for i, (writer, reader) in enumerate(((formats, jformats),
                                          (jformats, formats))):
        path = writer.embedded_path(str(tmp_path), "E", f"enc{i}")
        assert path == reader.embedded_path(str(tmp_path), "E", f"enc{i}")
        writer.save_embedded(path, **arrays)
        back = reader.load_pickle(path)
        for key, value in arrays.items():
            np.testing.assert_array_equal(back[key], value)
    assert formats.raw_path("d", "E") == jformats.raw_path("d", "E")


def test_flags_match_jax():
    """Same flag names and defaults; --disable_cuda parses alike."""
    want = vars(jflags.build_parser().parse_args([]))
    got = vars(flags.build_parser().parse_args([]))
    assert got == want
    argv = ["--disable_cuda", "--eval_batch", "4", "--compute_dtype",
            "bfloat16", "--disable_pretrained_embedding"]
    assert vars(flags.parser.parse_args(argv)) == \
        vars(jflags.parser.parse_args(argv))
    with pytest.raises(AttributeError):
        flags.default_flags(no_such_flag=1)


def test_stats_helpers_match_jax(tmp_path):
    fl = flags.default_flags(save_path="s", env="A", to_env="B", run_id=4)
    assert stats.run_save_path(fl) == jstats.run_save_path(fl)
    assert stats.run_save_path(fl, "x") == jstats.run_save_path(fl, "x")
    for epoch in range(0, 1000, 7):
        assert stats.is_essential_save(epoch, 1000, 3) == \
            jstats.is_essential_save(epoch, 1000, 3)
    s = stats.new_stats("B")
    assert s == jstats.new_stats("B")
    stats.append_eval(s, "B", {"episode_return": [1.0, 2.0],
                               "episode_success": [0.0, 1.0]})
    stats.append_nan_eval(s, "B")
    path = str(tmp_path / "s.pickle")
    stats.save_stats(path, s)
    back = jstats.load_stats(path)
    assert back["B"]["episode_return"][0] == 1.5
    assert np.isnan(back["B"]["episode_success"][1])
    with open(path, "rb") as handle:
        assert pickle.load(handle).keys() == {"B"}
