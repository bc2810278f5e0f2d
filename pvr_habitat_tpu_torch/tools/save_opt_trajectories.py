"""Expert-trajectory generation: roll the simulator's shortest-path
follower and record (obs, action, reward, done, true_state) pickles
(a copy of ``pvr_habitat_tpu/tools/save_opt_trajectories.py``; reference:
behavioral_cloning/save_opt_trajectories.py:25-113).  It runs on the host
only, so it needs no device and writes the same pickle as the JAX
package's tool for the same flags.

    python -m pvr_habitat_tpu_torch.tools.save_opt_trajectories \
        --env FakePointNav-apartment_0 --n_trajectories 4 --save_path DIR

Behavior fix vs. the reference: failed trajectories (no path found —
the GreedyFollowerError analogue) are SKIPPED instead of appending None
rows into the dataset (the reference appends them unguarded,
save_opt_trajectories.py:93-98 — a latent data-quality bug documented
in SURVEY.md §5)."""

import os
import pickle

import numpy as np

from pvr_habitat_tpu_torch.envs.make_env import make_gym_env
from pvr_habitat_tpu_torch.utils.flags import build_parser


def get_shortest_path(env):
    """Greedy shortest-path trajectory for the current episode.  Returns
    (obs, action, reward, done, true_state) with actions already
    STOP-free 0-based, or Nones when no path exists."""
    sim = env.unwrapped.sim
    raw_actions = sim.shortest_path_actions(
        max_steps=sim.max_episode_steps)
    if raw_actions is None or len(raw_actions) == 0:
        print("WARNING! Cannot find shortest path (GreedyFollowerError).")
        return None, None, None, None, None
    if len(raw_actions) >= sim.max_episode_steps:
        print("WARNING! Shortest path not found with the given steps "
              f"limit ({sim.max_episode_steps}). Returning best path.")
    else:
        print(f"Shortest path found: {len(raw_actions)} steps.")

    action = [a - 1 for a in raw_actions]  # STOP-free 0-based
    obs = [env.reset()]
    reward, done, true_state = [], [], [env._true_state]
    for a in action:
        o, r, d, _ = env.step(a)
        obs.append(o)
        reward.append(r)
        done.append(d)
        true_state.append(env._true_state)
    return obs[:-1], action, reward, done, true_state[:-1]


def gen_data_habitat(flags):
    flags.num_input_frames = 1
    flags.embedding_name = None
    env = make_gym_env(flags)

    data = dict(obs=[], action=[], reward=[], done=[], true_state=[])
    generated = 0
    attempts = 0
    while generated < flags.n_trajectories and \
            attempts < flags.n_trajectories * 3:
        attempts += 1
        env.randomize()
        env.reset()
        o, a, r, d, s = get_shortest_path(env)
        if o is None:
            continue
        data["obs"].append(np.asarray(o))
        data["action"].append(np.asarray(a))
        data["reward"].append(np.asarray(r))
        data["done"].append(np.asarray(d))
        data["true_state"].append(np.asarray(s))
        generated += 1

    os.makedirs(flags.save_path, exist_ok=True)
    out_path = os.path.join(flags.save_path, flags.env + ".pickle")
    with open(out_path, "wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)
    env.close()
    return out_path


def build_tool_parser():
    parser = build_parser()
    parser.add_argument("--n_trajectories", type=int, default=10000)
    return parser


if __name__ == "__main__":
    flags = build_tool_parser().parse_args()
    gen_data_habitat(flags)
