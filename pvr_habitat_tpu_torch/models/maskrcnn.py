"""Mask-R-CNN encoder (counterpart of ``pvr_habitat_tpu/models/maskrcnn.py``;
reference: src/vision_models/maskrcnn.py:23-137): the ResNet-50-C4
backbone up to res4 with the 11-channel compression BasicBlock grafted at
the end of res4 (``res4.6``; the reference empties ``res4[7]``), so the
output is the 11-channel res4 map flattened in NCHW order, 11*14*14 =
2156 for 224x224 inputs.

detectron2 specifics: FrozenBN (eval-mode BN), the stride on the 1x1
conv1 (``stride_in_1x1``; torchvision puts it on the 3x3), norm params
stored as ``<conv>.norm.*``, the shortcut named ``shortcut[.norm]``.
Everything runs on ``F.conv2d`` (routes ``("off",)``).  ``apply_int8`` is
the W8A8 serving path (``ops/quantize.py``); the FrozenBN ``<conv>.norm``
pairs fold like any eval-mode BN.
"""

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.ops import image as im
from pvr_habitat_tpu_torch.ops import quantize as q
from pvr_habitat_tpu_torch.utils.platform import resolve_device

# stage: (blocks, planes, out channels, stride of the first block)
STAGES = {"res2": (3, 64, 256, 1), "res3": (4, 128, 512, 2),
          "res4": (6, 256, 1024, 2)}
OUT_SIZE = 11 * 14 * 14


def _frozen_bn(x, p, prefix):
    return cm.batch_norm(x, p, prefix, train=False)


def _shortcut(x, p, prefix, stride):
    if f"{prefix}.shortcut.weight" not in p:
        return x
    y = cm.conv2d(x, p[f"{prefix}.shortcut.weight"], stride, 0)
    return _frozen_bn(y, p, f"{prefix}.shortcut.norm")


def _bottleneck(x, p, prefix, stride):
    # stride_in_1x1=True: the stride sits on conv1.
    y = cm.conv2d(x, p[f"{prefix}.conv1.weight"], stride, 0)
    y = torch.relu(_frozen_bn(y, p, f"{prefix}.conv1.norm"))
    y = cm.conv2d(y, p[f"{prefix}.conv2.weight"], 1, 1)
    y = torch.relu(_frozen_bn(y, p, f"{prefix}.conv2.norm"))
    y = cm.conv2d(y, p[f"{prefix}.conv3.weight"], 1, 0)
    y = _frozen_bn(y, p, f"{prefix}.conv3.norm")
    return torch.relu(y + _shortcut(x, p, prefix, stride))


def _basic(x, p, prefix, stride):
    y = cm.conv2d(x, p[f"{prefix}.conv1.weight"], stride, 1)
    y = torch.relu(_frozen_bn(y, p, f"{prefix}.conv1.norm"))
    y = cm.conv2d(y, p[f"{prefix}.conv2.weight"], 1, 1)
    y = _frozen_bn(y, p, f"{prefix}.conv2.norm")
    return torch.relu(y + _shortcut(x, p, prefix, stride))


def apply(params, x, train=False):
    """x: (N, 224, 224, 3) BGR mean-subtracted NHWC -> (N, 2156)."""
    del train  # FrozenBN everywhere
    y = cm.conv2d(x, params["stem.conv1.weight"], 2, 3)
    y = torch.relu(_frozen_bn(y, params, "stem.conv1.norm"))
    y = cm.max_pool(y, 3, 2, 1)
    for stage, (blocks, _, _, stride) in STAGES.items():
        for i in range(blocks):
            y = _bottleneck(y, params, f"{stage}.{i}",
                            stride if i == 0 else 1)
    # res4.6: the 1024 -> 11 compression BasicBlock; res4.7 was emptied.
    y = _basic(y, params, "res4.6", 1)
    return cm.flatten_nchw(y)


def _conv_q(qs, x, p, name, stride, padding):
    return q.conv_q(qs, name, x, p, stride, padding,
                    bias=q.affine_from_folded_bn(p, f"{name}.norm"))


def _shortcut_q(qs, x, p, prefix, stride):
    if f"{prefix}.shortcut.weight" not in p:
        return x
    return _conv_q(qs, x, p, f"{prefix}.shortcut", stride, 0)


def _bottleneck_q(qs, x, p, prefix, stride):
    y = _conv_q(qs, x, p, f"{prefix}.conv1", stride, 0).relu_()
    y = _conv_q(qs, y, p, f"{prefix}.conv2", 1, 1).relu_()
    y = _conv_q(qs, y, p, f"{prefix}.conv3", 1, 0)
    return torch.relu(y + _shortcut_q(qs, x, p, prefix, stride))


def _basic_q(qs, x, p, prefix, stride):
    y = _conv_q(qs, x, p, f"{prefix}.conv1", stride, 1).relu_()
    y = _conv_q(qs, y, p, f"{prefix}.conv2", 1, 1)
    return torch.relu(y + _shortcut_q(qs, x, p, prefix, stride))


def apply_int8(params_q, x, scales=None):
    """W8A8 serving path.  ``params_q``:
    ``quantize_resnet_params(fold_resnet_bn(params))``; ``scales=None``
    calibrates on this batch.  Returns (out (N, 2156), scales)."""
    qs = q.QuantState(scales)
    y = _conv_q(qs, x, params_q, "stem.conv1", 2, 3).relu_()
    y = cm.max_pool(y, 3, 2, 1).contiguous()
    for stage, (blocks, _, _, stride) in STAGES.items():
        for i in range(blocks):
            y = _bottleneck_q(qs, y, params_q, f"{stage}.{i}",
                              stride if i == 0 else 1)
    y = _basic_q(qs, y, params_q, "res4.6", 1)
    return cm.flatten_nchw(y), qs.scales


def _init_numpy(rng):
    out = {}

    def conv(name, o, i, k):
        out[f"{name}.weight"] = cm.kaiming_normal_conv(rng, (o, i, k, k))
        out[f"{name}.norm.weight"] = np.ones(o, np.float32)
        out[f"{name}.norm.bias"] = np.zeros(o, np.float32)
        out[f"{name}.norm.running_mean"] = np.zeros(o, np.float32)
        out[f"{name}.norm.running_var"] = np.ones(o, np.float32)

    conv("stem.conv1", 64, 3, 7)
    cin = 64
    for stage, (blocks, planes, cout, _) in STAGES.items():
        for i in range(blocks):
            pre = f"{stage}.{i}"
            conv(f"{pre}.conv1", planes, cin, 1)
            conv(f"{pre}.conv2", planes, planes, 3)
            conv(f"{pre}.conv3", cout, planes, 1)
            if i == 0:
                conv(f"{pre}.shortcut", cout, cin, 1)
            cin = cout
    conv("res4.6.conv1", 11, 1024, 3)
    conv("res4.6.conv2", 11, 11, 3)
    conv("res4.6.shortcut", 11, 1024, 1)
    return out


def init_params(rng, device=None):
    """The JAX package's init draw for draw; convs are OIHW."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in _init_numpy(rng).items()}


def build_maskrcnn_encoder(pretrained=True, checkpoint_dir=None,
                           device=None):
    from pvr_habitat_tpu_torch.models import convert
    from pvr_habitat_tpu_torch.models.registry import (EncoderHandle,
                                                       _load_or_init,
                                                       _name_seed)

    name = "maskrcnn_l3"
    dev = resolve_device(device)

    def load(ckpt):
        state_dict = ckpt.get("model", ckpt)
        # Keep only backbone.* keys (the reference discards the proposal
        # generator and ROI heads, maskrcnn.py:134).
        expected = set(_init_numpy(cm.ShapeRNG()))
        params = {k[len("backbone."):]: v.detach().float().to(dev)
                  for k, v in state_dict.items()
                  if k.startswith("backbone.")
                  and k[len("backbone."):] in expected}
        convert.check_expected(params, expected, context=name)
        return params

    params = _load_or_init(
        name, pretrained, checkpoint_dir, load,
        lambda: init_params(np.random.RandomState(_name_seed(name)), dev))

    return EncoderHandle(
        name, im.maskrcnn_preprocess(),
        lambda p, x, train=False: apply(p, x, train=train),
        params, OUT_SIZE)
