"""The weight bridge and checkpoint helpers (counterpart of
``pvr_habitat_tpu/models/convert.py``).

Both packages key their flat param dicts by the torch module path.  The
JAX package holds conv weights as HWIO numpy/jax arrays; the port holds
them as OIHW torch tensors.  ``params_from_numpy`` and
``params_to_numpy`` convert between the two exactly.

``save_flat``/``load_flat`` write and read the JAX package's payload
(tag ``pvr_habitat_tpu/flat-v1``, numpy arrays in HWIO), so a
``{name}.tar`` written by either package loads in the other.
"""

import pickle

import numpy as np
import torch

FLAT_FORMAT = "pvr_habitat_tpu/flat-v1"


def params_from_numpy(flat, device, dtype=torch.float32):
    """JAX-layout flat dict (HWIO numpy) -> torch tensors (OIHW) on
    ``device``: floats in ``dtype``, except the int8 path's f32
    '<name>.wscale' scales; integer arrays (int8 weights) keep their
    dtype."""
    out = {}
    for key, value in flat.items():
        arr = np.asarray(value)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        if np.issubdtype(arr.dtype, np.integer):
            dt = None
        else:
            dt = torch.float32 if key.endswith(".wscale") else dtype
        out[key] = torch.tensor(np.ascontiguousarray(arr), dtype=dt,
                                device=device)
    return out


def params_to_numpy(params):
    """torch tensors (OIHW) -> JAX-layout flat dict (HWIO numpy): floats
    as float32, integer tensors in their dtype."""
    out = {}
    for key, value in params.items():
        value = value.detach().cpu()
        if value.is_floating_point():
            value = value.float()
        arr = value.numpy()
        if arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
        out[key] = np.ascontiguousarray(arr)
    return out


def strip_module_prefix(state_dict):
    """'module.' DataParallel prefix removal
    (reference: src/vision_models/resnet.py:35-39)."""
    out = {}
    for key, value in state_dict.items():
        out[key[len("module."):] if key.startswith("module.") else key] = value
    return out


def moco_encoder_q(state_dict):
    """Keep only 'module.encoder_q.*' sans the projection fc
    (reference: src/vision_models/moco.py:14-21)."""
    prefix = "module.encoder_q."
    out = {}
    for key, value in state_dict.items():
        if key.startswith(prefix) and not key.startswith(prefix + "fc"):
            out[key[len(prefix):]] = value
    return out


def load_torch_checkpoint(path):
    """Deserialize a torch checkpoint file to a dict of tensors."""
    return torch.load(path, map_location="cpu", weights_only=False)


def check_expected(flat_params, expected_names, context=""):
    """Mirror the reference's missing-key asserts after surgery
    (src/vision_models/moco.py:24,68,111)."""
    missing = sorted(set(expected_names) - set(flat_params))
    if missing:
        raise ValueError(
            f"{context}: missing {len(missing)} params, e.g. {missing[:5]}")


def save_flat(path, params, extra=None):
    payload = {"format": FLAT_FORMAT, "params": params_to_numpy(params)}
    if extra:
        payload.update(extra)
    with open(path, "wb") as handle:
        pickle.dump(payload, handle, protocol=pickle.HIGHEST_PROTOCOL)


def load_flat(path, device):
    with open(path, "rb") as handle:
        payload = pickle.load(handle)
    return params_from_numpy(payload["params"], device)
