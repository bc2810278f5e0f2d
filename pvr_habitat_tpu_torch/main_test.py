"""Standalone policy evaluation — the port's counterpart of the JAX
package's ``main_test.py``: loads a run checkpoint (written by either
package), evaluates it greedily and writes
'test_{embedding}_from_{from_env}_to_{env}_{run_id}.pickle' in the
working directory.

    python -m pvr_habitat_tpu_torch.main_test --checkpoint RUN.tar \\
        --env FakePointNav-hotel_0 --from_env FakePointNav-hotel_0 \\
        --embedding_name random --data_path DIR [--disable_cuda]
"""

import os
import pickle

import numpy as np

from pvr_habitat_tpu_torch.envs.environment import make_environment
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.train.bc import flags_device
from pvr_habitat_tpu_torch.train.evaluate import PolicyRunner, test
from pvr_habitat_tpu_torch.utils import checkpoint as ckpt
from pvr_habitat_tpu_torch.utils.flags import build_parser

parser = build_parser()
parser.add_argument("--checkpoint", type=str, default=None,
                    help="Path to a run checkpoint (.tar).")
parser.add_argument("--from_env", type=str,
                    default="HabitatImageNav-apartment_0")
parser.add_argument("--logdir", type=str, default=None,
                    help="Scan this directory for a matching run instead "
                         "of passing --checkpoint.")


def _find_checkpoint(flags):
    if flags.checkpoint:
        return flags.checkpoint
    assert flags.logdir, "pass --checkpoint or --logdir"
    stem = (f"{flags.from_env}_em{flags.embedding_name}"
            f"_s{flags.run_id}_")
    for name in sorted(os.listdir(flags.logdir)):
        if name.startswith(stem) and name.endswith(".tar"):
            return os.path.join(flags.logdir, name)
    raise FileNotFoundError(f"no checkpoint matching {stem}* in "
                            f"{flags.logdir}")


def run(flags):
    device = flags_device(flags)
    stat_keys = ["episode_return", "episode_step", "episode_success"]

    payload = ckpt.load_checkpoint(_find_checkpoint(flags))

    embedding_model = EmbeddingNet(
        flags.embedding_name, in_channels=3,
        pretrained=flags.pretrained_embedding, train=flags.train_embedding,
        checkpoint_dir=flags.data_path, run_id=flags.run_id, device=device)
    if "embedding_model_state_dict" in payload:
        embedding_model.load_state_dict(payload["embedding_model_state_dict"])

    env = make_environment(flags, embedding_model)
    params, batch_stats = ckpt.split_actor_state(
        payload["actor_model_state_dict"], device)
    model = PolicyRunner(params, batch_stats,
                         batch_norm="fc.0.running_mean" in batch_stats)

    stats = test(model, env, stat_keys, flags.n_episodes_test)
    for key in stat_keys:
        print(key, float(np.mean(stats[key])))

    namefile = (f"test_{flags.embedding_name}_from_{flags.from_env}"
                f"_to_{flags.env}_{flags.run_id}")
    with open(namefile + ".pickle", "wb") as handle:
        pickle.dump(stats, handle, protocol=pickle.HIGHEST_PROTOCOL)
    env.close()
    return stats


if __name__ == "__main__":
    run(parser.parse_args())
