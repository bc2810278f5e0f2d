"""Bottleneck ResNet (arXiv:1512.03385, torchvision's resnet50) in
eval mode, NCHW, float32: the pooled feature, no classifier.  Every
BatchNorm runs on its running statistics as written, unfolded."""

import torch
import torch.nn.functional as F


def _bn(x, w, prefix, eps):
    return F.batch_norm(x, w[f"{prefix}.running_mean"],
                        w[f"{prefix}.running_var"], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], training=False, eps=eps)


def _block(x, w, prefix, stride, eps):
    y = F.relu(_bn(F.conv2d(x, w[f"{prefix}.conv1.weight"]), w,
                   f"{prefix}.bn1", eps))
    y = F.relu(_bn(F.conv2d(y, w[f"{prefix}.conv2.weight"], stride=stride,
                            padding=1), w, f"{prefix}.bn2", eps))
    y = _bn(F.conv2d(y, w[f"{prefix}.conv3.weight"]), w, f"{prefix}.bn3",
            eps)
    if f"{prefix}.downsample.0.weight" in w:
        x = _bn(F.conv2d(x, w[f"{prefix}.downsample.0.weight"],
                         stride=stride), w, f"{prefix}.downsample.1", eps)
    return F.relu(y + x)


def forward(x, w, enc):
    """x: (N, 3, 224, 224) normalized -> (N, out_size)."""
    eps = enc["bn_eps"]
    y = F.relu(_bn(F.conv2d(x, w["conv1.weight"], stride=2, padding=3), w,
                   "bn1", eps))
    y = F.max_pool2d(y, 3, 2, 1)
    for stage, blocks in enumerate(enc["blocks"]):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            y = _block(y, w, f"layer{stage + 1}.{i}", stride, eps)
    return y.mean(dim=(2, 3))
