"""Run statistics and save gating (a copy of
``pvr_habitat_tpu/utils/stats.py``; reference: src/utils_bc.py:5-12,
main_bc_2.py:165-179,240-246).  The stats pickle layout is the drop-in
public contract: {to_env: {episode_return: [], episode_success: [],
frames: [], training_loss: [], gradient_norm: []}} with NaN placeholders
for skipped evals."""

import os
import pickle

import numpy as np

STAT_KEYS = ("episode_return", "episode_success")


def is_essential_save(epoch, max_epochs, eval_frequency):
    """Only persist near the 1/10/50/97 % marks (+- 5*eval_frequency)."""
    essential_saves = [0.01, 0.1, 0.5, 0.97]
    essential_saves = [int(e * max_epochs) for e in essential_saves]
    window = 5 * eval_frequency
    return any(es - window <= epoch < es + window for es in essential_saves)


def new_stats(to_env, stat_keys=STAT_KEYS):
    return {to_env: {**{k: [] for k in stat_keys},
                     "frames": [], "training_loss": [], "gradient_norm": []}}


def load_stats(path):
    with open(path, "rb") as handle:
        return pickle.load(handle)


def save_stats(path, stats):
    tmp = path + ".tmp"
    with open(tmp, "wb") as handle:
        pickle.dump(stats, handle, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def append_eval(stats, to_env, stats_ep, stat_keys=STAT_KEYS):
    for k in stat_keys:
        stats[to_env][k].append(float(np.mean(stats_ep[k])))


def append_nan_eval(stats, to_env, stat_keys=STAT_KEYS):
    for k in stat_keys:
        stats[to_env][k].append(np.nan)


def run_save_path(flags, embedding_label=None):
    """'{save_path}/{env}_em{embedding}_s{run_id}_{to_env}' naming
    (reference: main_bc_2.py:43-47)."""
    label = embedding_label or flags.embedding_name
    return os.path.join(
        flags.save_path,
        f"{flags.env}_em{label}_s{flags.run_id}_{flags.to_env}")
