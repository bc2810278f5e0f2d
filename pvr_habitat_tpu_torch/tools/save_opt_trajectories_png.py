"""Expert-trajectory generation, PNG layout: per-step frames as
'{t}_{s}.png' + '{t}_goal.png' + per-trajectory metadata pickle
(counterpart of ``pvr_habitat_tpu/tools/save_opt_trajectories_png.py``;
reference: behavioral_cloning/save_opt_trajectories_png.py:28-65).  It
runs on the host only and writes the files the JAX package's tool writes
for the same flags.

    python -m pvr_habitat_tpu_torch.tools.save_opt_trajectories_png \\
        --env FakePointNav-apartment_0 --n_trajectories 4 --save_path DIR
"""

import os

import numpy as np

from pvr_habitat_tpu_torch.data import formats
from pvr_habitat_tpu_torch.envs.make_env import make_gym_env
from pvr_habitat_tpu_torch.tools.save_opt_trajectories import (
    build_tool_parser, get_shortest_path)


def gen_data_habitat(flags):
    flags.num_input_frames = 1
    flags.embedding_name = None
    env = make_gym_env(flags)

    save_path = os.path.join(flags.save_path, flags.env)
    os.makedirs(save_path, exist_ok=True)

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
        formats.save_png_trajectory(
            save_path, generated, [np.asarray(f) for f in o],
            np.asarray(a), np.asarray(r), np.asarray(d), np.asarray(s))
        generated += 1

    env.close()
    return save_path


if __name__ == "__main__":
    gen_data_habitat(build_tool_parser().parse_args())
