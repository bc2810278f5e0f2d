"""Expert-trajectory generation, JPEG layout for encoder pre-training:
frameskipped frames + agent pose only (counterpart of
``pvr_habitat_tpu/tools/save_opt_trajectories_jpeg.py``; reference:
behavioral_cloning/save_opt_trajectories_jpeg.py:29-62).  The frames are
written by PIL, which this tool needs.

    python -m pvr_habitat_tpu_torch.tools.save_opt_trajectories_jpeg \\
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
        formats.save_jpeg_trajectory(
            save_path, generated, [np.asarray(f) for f in o],
            np.asarray(s), frameskip=flags.frameskip)
        generated += 1

    env.close()
    return save_path


def build_jpeg_parser():
    parser = build_tool_parser()
    parser.add_argument("--frameskip", type=int, default=3)
    return parser


if __name__ == "__main__":
    gen_data_habitat(build_jpeg_parser().parse_args())
