"""On-disk trajectory/dataset formats — the drop-in public contract
(counterpart of ``pvr_habitat_tpu/data/formats.py``; its pickle parts,
copied):

- Raw trajectory pickle '{data_path}/{env}.pickle': dict(obs, action,
  reward, done, true_state), each a LIST of per-trajectory arrays; obs
  (T,64,64,3) uint8 PointNav or (T,64,64,6) ImageNav; actions STOP-free
  0-based ints (save_opt_trajectories.py:25-31,100-106).
- Embedded pickle '{data_path}/{env}_{embedding}.pickle': flat arrays
  obs (N, O*n_frames) float, action/reward/done (N,), true_state (N,12)
  (save_embedded_obs.py:159-172).

The PNG and JPEG per-frame layouts come with the bulk-embedding item
(ROADMAP.md queue 1, items 3 and 4).
"""

import os
import pickle

import numpy as np


def save_raw_trajectories(path, data):
    with open(path, "wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)


def load_pickle(path):
    with open(path, "rb") as handle:
        return pickle.load(handle)


def read_habitat_data(data_path, n_trajectories=-1, verbose=True):
    """Load + merge per-trajectory lists (reference: src/utils_bc.py:33-49)."""
    if verbose:
        print(f"loading {data_path} ...")
    data = load_pickle(data_path)
    if n_trajectories == -1:
        n_trajectories = len(data["reward"])
    out = {}
    for key in ("obs", "action", "reward", "done", "true_state"):
        out[key] = np.concatenate(data[key][:n_trajectories])
    n_samples = len(out["reward"])
    if verbose:
        print(f"   {n_trajectories} trajectories for a total of "
              f"{n_samples} samples")
        print("   avg. return is", out["reward"].sum() / n_trajectories)
    return out


def save_embedded(path, obs, action, reward, done, true_state):
    data = dict(obs=np.asarray(obs), action=np.asarray(action),
                reward=np.asarray(reward), done=np.asarray(done),
                true_state=np.asarray(true_state))
    with open(path, "wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)


def embedded_path(data_path, env, embedding_name):
    return os.path.join(data_path, f"{env}_{embedding_name}.pickle")


def raw_path(data_path, env):
    return os.path.join(data_path, f"{env}.pickle")
