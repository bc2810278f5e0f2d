"""The 'random' encoder: untrained, orthogonally-initialized
5x(conv3x3 stride2 pad1 -> ELU), 32 channels (counterpart of
``pvr_habitat_tpu/models/random_conv.py``; reference:
src/embeddings.py:90-106).  Seed-dependent by design."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.utils.platform import resolve_device


def init_params(rng, device=None):
    dev = resolve_device(device)
    out = {}
    ch_in = 3
    for i in range(5):
        out[f"{2 * i}.weight"] = cm.orthogonal_conv(
            rng, (32, ch_in, 3, 3), gain=math.sqrt(2.0))
        out[f"{2 * i}.bias"] = np.zeros(32, np.float32)
        ch_in = 32
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in out.items()}


def apply(params, x, train=False):
    """x: (N, H, W, 3) normalized float -> (N, 32 * ceil(H/32) * ceil(W/32))."""
    del train
    y = x
    for i in range(5):
        y = cm.conv2d(y, params[f"{2 * i}.weight"], stride=2, padding=1,
                      bias=params[f"{2 * i}.bias"])
        y = F.elu(y)
    return cm.flatten_nchw(y)


def out_size(input_hw=224):
    side = input_hw
    for _ in range(5):
        side = (side + 1) // 2
    return 32 * side * side
