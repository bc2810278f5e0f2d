"""Generate the seed PointNav episode dataset habitat-lab expects (a copy
of ``pvr_habitat_tpu/tools/make_episode_dataset.py``; the reference ships
habitat_config/replica_train.json.gz with one episode per scene; actual
episodes come from randomize() at runtime, src/gym_wrappers.py:276-285 —
the file only bootstraps the env).

    python -m pvr_habitat_tpu_torch.tools.make_episode_dataset \
        --scene_path mesh.ply --out habitat_config/replica_train.json.gz
"""

import argparse
import gzip
import json
import os


def make_dataset(scene_path, start=(0.0, 0.0, 0.0), goal=(1.0, 0.0, 1.0)):
    return {
        "episodes": [{
            "episode_id": "0",
            "scene_id": scene_path,
            "start_position": list(start),
            "start_rotation": [0.0, 0.0, 0.0, 1.0],
            "info": {},
            "goals": [{"position": list(goal), "radius": None}],
            "shortest_paths": None,
            "start_room": None,
        }],
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene_path", type=str,
                        default="mesh.ply",
                        help="Scene asset path, relative to SCENES_DIR.")
    parser.add_argument("--out", type=str,
                        default="habitat_config/replica_train.json.gz")
    args = parser.parse_args()

    payload = json.dumps(make_dataset(args.scene_path))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.out.endswith(".gz"):
        with gzip.open(args.out, "wt") as handle:
            handle.write(payload)
    else:
        with open(args.out, "w") as handle:
            handle.write(payload)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
