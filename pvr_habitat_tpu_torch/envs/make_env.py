"""Env factory (counterpart of ``pvr_habitat_tpu/envs/make_env.py``;
reference: src/gym_wrappers.py:35-90).

Routes env-name strings:
  'FakeImageNav-<scene>' / 'FakePointNav-<scene>'
      -> the hermetic FakeNav simulator.
  'HabitatImageNav-<scene>' / 'HabitatPointNav-<scene>'
      -> FakeNav with identical wrapper semantics while habitat-sim is
         not installed.  The habitat adapter is not ported yet, so an
         installed habitat raises instead of being ignored.
  'Atari-<id>' / 'MiniGrid<id>'
      -> not ported yet; raises.
Then: seed, EmbeddingWrapper (unless true_state), FrameStack.
"""

from pvr_habitat_tpu_torch.envs.fake_nav import FakeNavSim
from pvr_habitat_tpu_torch.envs.wrappers import (EmbeddingWrapper,
                                                 FrameStack,
                                                 NavigationWrapper)

ADAPTERS_ITEM = "ROADMAP.md queue 1, item 2"


def _habitat_available():
    try:
        import habitat  # noqa: F401
        return True
    except ImportError:
        return False


def make_gym_env(flags, embedding_model=None, seed=0):
    env_name = flags.env
    embedding_name = getattr(flags, "embedding_name", None)

    if "Habitat" in env_name or "Fake" in env_name:
        scene = env_name.split("-")[1]
        assert len(scene) > 0, "Undefined scene."
        image_goal = "ImageNav" in env_name
        true_state = embedding_name == "true_state"
        if "Habitat" in env_name:
            if _habitat_available():
                raise NotImplementedError(
                    f"'{env_name}': habitat-sim is installed but its "
                    f"adapter is not ported yet ({ADAPTERS_ITEM})")
            import warnings

            warnings.warn(
                f"habitat-sim not installed; '{env_name}' runs on the "
                "hermetic FakeNav simulator")
        max_steps = getattr(flags, "max_episode_steps", 0)
        sim = FakeNavSim(scene, seed=seed,
                         **({"max_episode_steps": max_steps}
                            if max_steps else {}))
        env = NavigationWrapper(sim, scene, image_goal=image_goal,
                                true_state=true_state, seed=seed)
    elif "Atari" in env_name or "MiniGrid" in env_name:
        raise NotImplementedError(
            f"'{env_name}': the gym adapter is not ported yet "
            f"({ADAPTERS_ITEM})")
    else:
        raise NotImplementedError(f"unknown environment: {env_name}")

    env.seed(seed)

    if embedding_model is not None and embedding_name != "true_state":
        env = EmbeddingWrapper(env, embedding_model)

    if flags.num_input_frames > 1:
        env = FrameStack(env, flags.num_input_frames)

    return env
