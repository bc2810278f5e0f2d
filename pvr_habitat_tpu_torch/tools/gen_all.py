"""Dataset-generation CLI — the reference's save_all{,_png,_jpeg}.sh
loops as one CLI (counterpart of ``pvr_habitat_tpu/tools/gen_all.py``;
behavioral_cloning/save_all*.sh).

  python -m pvr_habitat_tpu_torch.tools.gen_all --layout pickle --task PointNav
  python -m pvr_habitat_tpu_torch.tools.gen_all --layout jpeg --all_scenes

Default scene set mirrors the reference: 5 scenes for pickle/png
(10k trajectories each), all 18 Replica scenes for jpeg (20k each,
frameskip 3).  Use --fake for the hermetic simulator.
"""

import argparse

from pvr_habitat_tpu_torch.utils.flags import build_parser

BC_SCENES = ["apartment_0", "frl_apartment_0", "office_0", "room_0",
             "hotel_0"]
ALL_SCENES = [
    "apartment_0", "apartment_1", "apartment_2",
    "frl_apartment_0", "frl_apartment_1", "frl_apartment_2",
    "frl_apartment_3", "frl_apartment_4", "frl_apartment_5",
    "office_0", "office_1", "office_2", "office_3", "office_4",
    "room_0", "room_1", "room_2", "hotel_0",
]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--layout", choices=["pickle", "png", "jpeg"],
                        default="pickle")
    parser.add_argument("--task", choices=["PointNav", "ImageNav"],
                        default="PointNav")
    parser.add_argument("--n_trajectories", type=int, default=0,
                        help="0 = reference defaults (10k / 20k jpeg)")
    parser.add_argument("--save_path", type=str, default="behavioral_cloning")
    parser.add_argument("--all_scenes", action="store_true")
    parser.add_argument("--fake", action="store_true")
    parser.add_argument("--frameskip", type=int, default=3)
    parser.add_argument("--max_episode_steps", type=int, default=0)
    args = parser.parse_args()

    scenes = ALL_SCENES if (args.all_scenes or args.layout == "jpeg") \
        else BC_SCENES
    n_default = 20000 if args.layout == "jpeg" else 10000
    prefix = ("Fake" if args.fake else "Habitat") + args.task

    for scene in scenes:
        flags = build_parser().parse_args([])
        flags.env = f"{prefix}-{scene}"
        flags.save_path = args.save_path
        flags.n_trajectories = args.n_trajectories or n_default
        flags.max_episode_steps = args.max_episode_steps
        flags.frameskip = args.frameskip
        print(f"=== generating {flags.env} ({args.layout}) ===")
        if args.layout == "pickle":
            from pvr_habitat_tpu_torch.tools import save_opt_trajectories \
                as tool
        elif args.layout == "png":
            from pvr_habitat_tpu_torch.tools import \
                save_opt_trajectories_png as tool
        else:
            from pvr_habitat_tpu_torch.tools import \
                save_opt_trajectories_jpeg as tool
        tool.gen_data_habitat(flags)


if __name__ == "__main__":
    main()
