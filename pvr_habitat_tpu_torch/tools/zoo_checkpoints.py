"""Seeded encoder checkpoints in the reference's file layouts.

    python -m pvr_habitat_tpu_torch.tools.zoo_checkpoints --dir DIR \\
        --names clip_vit clip_rn50 maskrcnn_l3 moco_aug_uber_345 [--seed 0]

Writes each encoder's weights under the filename and key layout the
registry loads (``CHECKPOINT_FILES``): MoCo and demy ``{"state_dict":
{"module.encoder_q.*"}}``, the torchvision ResNets ``{"state_dict":
{"module.*"}}``, CLIP the OpenAI ``visual.*`` state dict, Mask R-CNN
``{"model": {"backbone.*"}}``, MAE ``{"model": ...}``; an uber fusion
writes its constituents.  ``EmbeddingNet(name, checkpoint_dir=DIR)`` then
loads them through the pretrained path.

The weights are the name-seeded init (the JAX package's draws), with
every BatchNorm given trained-like statistics drawn from ``seed``: running
stats and affine params near the identity, and a small scale (0.1-0.3) on
the last BN of each residual branch, as a trained ResNet has.  The
seeded init's identity BNs let activations grow about 1e4-fold over a
trunk, where f32 results of two libraries part by more than 1e-3 on the
elements that cancel; these keep them near a trained network's scale.
"""

import argparse
import os
import re

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import registry

# the affine params of a BN: '<conv>.norm', 'bnN', 'downsample.1'
BN_AFFINE = re.compile(r"(\.norm|(^|\.)bn\d|\.downsample\.1)\.(weight|bias)$")
# the scale of the last BN of a residual branch: bottlenecks, the l3/l4
# compress grafts and Mask R-CNN's res4.6
BRANCH_END = re.compile(r"((^|\.)bn3|conv3\.norm|layer[34]\.1\.bn2"
                        r"|res4\.6\.conv2\.norm)\.weight$")


def trained_like(params, seed):
    """A copy of a flat param dict with every BN's statistics drawn from
    ``seed`` (see the module docstring); other params are kept."""
    rng = np.random.RandomState(seed)
    out = dict(params)
    for key, value in params.items():
        shape = tuple(value.shape)
        if key.endswith("running_mean"):
            new = rng.randn(*shape) * 0.05
        elif key.endswith("running_var"):
            new = rng.rand(*shape) * 0.5 + 0.75
        elif BRANCH_END.search(key):
            new = 0.1 + 0.2 * rng.rand(*shape)
        elif BN_AFFINE.search(key):
            base = 1.0 if key.endswith("weight") else 0.0
            new = base + rng.randn(*shape) * 0.05
        else:
            continue
        out[key] = torch.from_numpy(new.astype(np.float32)).to(value.device)
    return out


def _payload(name, state):
    if name == "maskrcnn_l3":
        return {"model": {f"backbone.{k}": v for k, v in state.items()}}
    if name.startswith("moco_") or name == "demy":
        return {"state_dict": {f"module.encoder_q.{k}": v
                               for k, v in state.items()}}
    if name.startswith("resnet"):
        return {"state_dict": {f"module.{k}": v for k, v in state.items()}}
    if name.startswith("mae_"):
        return {"model": state}
    return state                        # CLIP: the visual.* state dict


def write(name, directory, seed=0):
    """Writes ``name``'s checkpoint file(s) into ``directory``; returns
    their paths.  An uber fusion writes one file per constituent, the
    i-th from ``seed + i``."""
    subs = (registry.uber_constituents(name) if "_uber_" in name
            else (name,))
    paths = []
    for i, sub in enumerate(subs):
        if sub not in registry.CHECKPOINT_FILES:
            raise ValueError(f"'{sub}' loads no checkpoint")
        handle = registry.build_encoder(sub, pretrained=False, device="cpu")
        path = os.path.join(directory, registry.CHECKPOINT_FILES[sub])
        torch.save(_payload(sub, trained_like(handle.params, seed + i)),
                   path)
        paths.append(path)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dir", required=True)
    parser.add_argument("--names", nargs="+", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    os.makedirs(args.dir, exist_ok=True)
    for name in args.names:
        for path in write(name, args.dir, args.seed):
            print(path)


if __name__ == "__main__":
    main()
