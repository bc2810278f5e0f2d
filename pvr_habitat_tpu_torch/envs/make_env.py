"""Env factory (counterpart of ``pvr_habitat_tpu/envs/make_env.py``;
reference: src/gym_wrappers.py:35-90).

Routes env-name strings:
  'HabitatImageNav-<scene>' / 'HabitatPointNav-<scene>'
      -> habitat-sim when installed (``envs/habitat_adapter.py``), else
         the hermetic FakeNav simulator with identical wrapper semantics
         (with a warning).
  'FakeImageNav-<scene>' / 'FakePointNav-<scene>'
      -> FakeNav explicitly.
  'Atari-<id>' / 'MiniGrid<id>'
      -> gym adapters (``envs/gym_adapter.py``), available only when gym
         is installed.
Then: seed, EmbeddingWrapper (unless true_state), FrameStack.
"""

from pvr_habitat_tpu_torch.envs.fake_nav import FakeNavSim
from pvr_habitat_tpu_torch.envs.wrappers import (EmbeddingWrapper,
                                                 FrameStack,
                                                 NavigationWrapper)


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
        if "Habitat" in env_name and _habitat_available():
            from pvr_habitat_tpu_torch.envs.habitat_adapter import \
                make_habitat_sim
            sim = make_habitat_sim(scene, seed=seed)
        else:
            if "Habitat" in env_name:
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
        from pvr_habitat_tpu_torch.envs.gym_adapter import make_gym_adapter
        env = make_gym_adapter(env_name)
    else:
        raise NotImplementedError(f"unknown environment: {env_name}")

    env.seed(seed)

    if embedding_model is not None and embedding_name != "true_state":
        env = EmbeddingWrapper(env, embedding_model)

    if flags.num_input_frames > 1:
        env = FrameStack(env, flags.num_input_frames)

    return env
