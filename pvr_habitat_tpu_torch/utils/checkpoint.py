"""Checkpoint save/restore keeping the reference's '.tar' file contract
(counterpart of ``pvr_habitat_tpu/utils/checkpoint.py``; reference:
main_bc_2.py:252-260): one pickle per run holding embedding/actor/
optimizer/scheduler state plus the flags dict.  Payload tensors are numpy
arrays in the JAX package's layout, so a checkpoint written by either
package loads in the other."""

import os
import pickle

from pvr_habitat_tpu_torch.models import convert
from pvr_habitat_tpu_torch.train import optim
from pvr_habitat_tpu_torch.utils.platform import resolve_device

FORMAT = "pvr_habitat_tpu/ckpt-v1"


def _to_numpy(tree):
    """A flat dict of tensors -> numpy; ``()`` (no momentum) stays ``()``."""
    return convert.params_to_numpy(tree) if isinstance(tree, dict) else tree


def _to_tensors(tree, device):
    return (convert.params_from_numpy(tree, device)
            if isinstance(tree, dict) else tree)


def save_checkpoint(path, *, actor_params, actor_batch_stats, opt_state,
                    flags, embedding_state=None):
    payload = {
        "format": FORMAT,
        "actor_model_state_dict": _to_numpy(
            {**actor_params, **actor_batch_stats}),
        "actor_model_optimizer_state_dict": {
            "count": int(opt_state.count),
            "square_avg": _to_numpy(opt_state.square_avg),
            "momentum_buf": _to_numpy(opt_state.momentum_buf),
        },
        # torch LambdaLR state analogue: number of scheduler steps taken.
        "scheduler_state_dict": {"last_epoch": int(opt_state.count)},
        "flags": {k: v for k, v in vars(flags).items()
                  if not k.startswith("_")},
    }
    if embedding_state is not None:   # numpy, from EmbeddingNet.state_dict
        payload["embedding_model_state_dict"] = dict(embedding_state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as handle:
        pickle.dump(payload, handle, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path):
    with open(path, "rb") as handle:
        return pickle.load(handle)


def split_actor_state(state_dict, device=None):
    """torch-style merged state dict -> (params, batch_stats) tensors on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    params = {k: v for k, v in state_dict.items() if "running_" not in k}
    stats = {k: v for k, v in state_dict.items() if "running_" in k}
    return _to_tensors(params, device), _to_tensors(stats, device)


def restore_opt_state(payload, device=None):
    device = resolve_device(device)
    opt = payload["actor_model_optimizer_state_dict"]
    return optim.RMSpropTorchState(
        count=int(opt["count"]),
        square_avg=_to_tensors(opt["square_avg"], device),
        momentum_buf=_to_tensors(opt["momentum_buf"], device),
    )
