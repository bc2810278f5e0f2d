"""torchvision-style ResNets and the reference's truncated/compressed
variants, NHWC-functional (counterpart of
``pvr_habitat_tpu/models/resnet.py``).

- resnet18/34/50 with the classifier removed: the output is the pooled
  2048-d (or 512-d) feature.
- ``l3``/``l4`` compressed variants: ResNet-50 cut at layer3/layer4 with
  an appended BasicBlock compressing 1024->11 / 2048->42 channels and a
  3x3-conv+BN projection shortcut.  The output is the feature map
  flattened in torch's NCHW order: 11*14*14 = 2156 / 42*7*7 = 2058.

Parameter keys mirror the grafted torch modules: the original layer3
blocks live under ``layer3.0.<i>...`` and the compress block under
``layer3.1...``.  Conv weights are OIHW.

``apply_fused`` and ``apply_fused_v2`` route the bottleneck blocks
through the Hopper kernels of ``ops/cuda/fused_bottleneck.py``; the stem
conv, max pool, basic blocks and compress grafts run on
``F.conv2d``/``F.max_pool2d``, the same work the JAX package leaves to
XLA outside its Pallas kernels.  ``apply_int8``
is the W8A8 serving path (``ops/quantize.py``).
"""

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.ops import quantize as q
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
from pvr_habitat_tpu_torch.utils.platform import resolve_device


BLOCK_COUNTS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
BLOCK_TYPE = {18: "basic", 34: "basic", 50: "bottleneck"}
EXPANSION = {"basic": 1, "bottleneck": 4}


class ResNetSpec:
    def __init__(self, depth=50, cut=None):
        """cut: None (full, pooled output) | 'l3' | 'l4' (compressed)."""
        self.depth = depth
        self.block = BLOCK_TYPE[depth]
        self.layers = BLOCK_COUNTS[depth]
        self.cut = cut
        if cut == "l3":
            self.compress_in, self.compress_out = 1024, 11
        elif cut == "l4":
            self.compress_in, self.compress_out = 2048, 42
        elif cut is not None:
            raise ValueError(f"unknown cut: {cut}")

    def out_size(self, input_hw=224):
        if self.cut == "l3":
            s = input_hw // 16
            return 11 * s * s
        if self.cut == "l4":
            s = input_hw // 32
            return 42 * s * s
        return 512 * EXPANSION[self.block]

    def param_names(self):
        return sorted(_init_numpy(self, cm.ShapeRNG()).keys())


def _grafted(spec, stage_idx):
    return (spec.cut == "l3" and stage_idx == 2) or \
        (spec.cut == "l4" and stage_idx == 3)


def _basic_block(x, p, prefix, stride, has_downsample, train):
    identity = x
    y = cm.conv2d(x, p[f"{prefix}.conv1.weight"], stride=stride, padding=1)
    y = torch.relu(cm.batch_norm(y, p, f"{prefix}.bn1", train=train))
    y = cm.conv2d(y, p[f"{prefix}.conv2.weight"], stride=1, padding=1)
    y = cm.batch_norm(y, p, f"{prefix}.bn2", train=train)
    if has_downsample:
        dw = p[f"{prefix}.downsample.0.weight"]
        pad = (dw.shape[-1] - 1) // 2  # 1x1 in stages, 3x3 in compress blocks
        # The compress graft's shortcut conv keeps torch's default bias=True.
        identity = cm.conv2d(x, dw, stride=stride, padding=pad,
                             bias=p.get(f"{prefix}.downsample.0.bias"))
        identity = cm.batch_norm(identity, p, f"{prefix}.downsample.1",
                                 train=train)
    return torch.relu(y + identity)


def _bottleneck_block(x, p, prefix, stride, has_downsample, train):
    identity = x
    y = cm.conv2d(x, p[f"{prefix}.conv1.weight"], stride=1, padding=0)
    y = torch.relu(cm.batch_norm(y, p, f"{prefix}.bn1", train=train))
    y = cm.conv2d(y, p[f"{prefix}.conv2.weight"], stride=stride, padding=1)
    y = torch.relu(cm.batch_norm(y, p, f"{prefix}.bn2", train=train))
    y = cm.conv2d(y, p[f"{prefix}.conv3.weight"], stride=1, padding=0)
    y = cm.batch_norm(y, p, f"{prefix}.bn3", train=train)
    if has_downsample:
        identity = cm.conv2d(x, p[f"{prefix}.downsample.0.weight"],
                             stride=stride, padding=0)
        identity = cm.batch_norm(identity, p, f"{prefix}.downsample.1",
                                 train=train)
    return torch.relu(y + identity)


def _stage(x, p, name, spec, stage_idx, train):
    """One of layer1..layer4.  When the stage carries a compress graft the
    original blocks are nested under '<name>.0' and the BasicBlock
    compressor under '<name>.1'."""
    block_fn = _basic_block if spec.block == "basic" else _bottleneck_block
    grafted = _grafted(spec, stage_idx)
    base = f"{name}.0" if grafted else name
    for i in range(spec.layers[stage_idx]):
        stride = 2 if (i == 0 and stage_idx > 0) else 1
        has_ds = f"{base}.{i}.downsample.0.weight" in p
        x = block_fn(x, p, f"{base}.{i}", stride, has_ds, train)
    if grafted:
        x = _basic_block(x, p, f"{name}.1", 1, True, train)
    return x


def _stem(params, x, train=False):
    y = cm.conv2d(x, params["conv1.weight"], stride=2, padding=3)
    y = torch.relu(cm.batch_norm(y, params, "bn1", train=train))
    return cm.max_pool(y, window=3, stride=2, padding=1).contiguous()


def apply(params, x, spec, train=False):
    """x: (N, H, W, 3) normalized float NHWC -> (N, out_size)."""
    y = _stem(params, x, train)
    y = _stage(y, params, "layer1", spec, 0, train)
    y = _stage(y, params, "layer2", spec, 1, train)
    y = _stage(y, params, "layer3", spec, 2, train)
    if spec.cut == "l3":
        return cm.flatten_nchw(y)
    y = _stage(y, params, "layer4", spec, 3, train)
    if spec.cut == "l4":
        return cm.flatten_nchw(y)
    return y.mean(dim=(1, 2))  # adaptive avgpool (1,1) + flatten


def apply_fused(params, x, spec):
    """Inference path with every bottleneck block on the v1 kernel (16
    launches for ResNet-50).  ``params`` must be BN-FOLDED
    (ops.fold_bn.fold_resnet_bn); compress grafts stay unfused."""
    if spec.block != "bottleneck":
        raise ValueError("the fused path is for bottleneck nets")
    y = _stem(params, x)
    for stage_idx in range(4 if spec.cut != "l3" else 3):
        name = f"layer{stage_idx + 1}"
        grafted = _grafted(spec, stage_idx)
        base = f"{name}.0" if grafted else name
        for i in range(spec.layers[stage_idx]):
            stride = 2 if (i == 0 and stage_idx > 0) else 1
            w = fb.block_weights(params, f"{base}.{i}", dtype=x.dtype)
            y = fb.fused_bottleneck(y, *w, stride=stride)
        if grafted:
            y = _basic_block(y, params, f"{name}.1", 1, True, False)
    if spec.cut in ("l3", "l4"):
        return cm.flatten_nchw(y)
    return y.mean(dim=(1, 2))


def _flat_blocks(y, params, name, first, n_blocks):
    """Blocks ``first..n_blocks-1`` of a stage on the v2 kernel."""
    h = y.shape[1]
    mask = torch.as_tensor(fb.flat_mask(h, h), device=y.device)
    yf = fb.to_padded_flat(y)
    for i in range(first, n_blocks):
        w = fb.block_weights(params, f"{name}.{i}", dtype=y.dtype)
        yf = fb.fused_bottleneck_flat(yf, mask, *w, h=h, w=h)
    return fb.from_padded_flat(yf, h, h).contiguous()


def apply_fused_v2(params, x, spec):
    """Padded-flat path: every stride-1 bottleneck block on the v2 kernel
    (13 launches for ResNet-50); the stride-2 stage heads stay on
    ``F.conv2d``.  ``params`` must be BN-folded."""
    if spec.block != "bottleneck" or spec.cut is not None:
        raise ValueError("the v2 path covers the full bottleneck nets")
    y = _stem(params, x)
    for stage_idx in range(4):
        name = f"layer{stage_idx + 1}"
        first = 0
        if stage_idx > 0:
            y = _bottleneck_block(y, params, f"{name}.0", 2, True, False)
            first = 1
        y = _flat_blocks(y, params, name, first, spec.layers[stage_idx])
    return y.mean(dim=(1, 2))


FUSED_APPLY = {"v1": apply_fused, "v2": apply_fused_v2}


def fused_routes(spec):
    """The ``fused`` values a spec can run: v2 covers the full bottleneck
    nets only; basic-block nets have no kernel."""
    if spec.block != "bottleneck":
        return ("off",)
    if spec.cut is not None:
        return ("off", "v1")
    return ("off", "v1", "v2")


# -----------------------------------------------------------------------------
# W8A8 int8 serving path (ops/quantize.py): every conv int8, the max pool,
# residual adds and the mean in the input dtype (bf16 when serving).
# -----------------------------------------------------------------------------


def _bottleneck_block_q(qs, x, p, prefix, stride):
    y = q.conv_q(qs, f"{prefix}.conv1", x, p, 1, 0,
                 bias=q.affine_from_folded_bn(p, f"{prefix}.bn1")).relu_()
    y = q.conv_q(qs, f"{prefix}.conv2", y, p, stride, 1,
                 bias=q.affine_from_folded_bn(p, f"{prefix}.bn2")).relu_()
    y = q.conv_q(qs, f"{prefix}.conv3", y, p, 1, 0,
                 bias=q.affine_from_folded_bn(p, f"{prefix}.bn3"))
    identity = x
    if f"{prefix}.downsample.0.weight" in p:
        identity = q.conv_q(
            qs, f"{prefix}.downsample.0", x, p, stride, 0,
            bias=q.affine_from_folded_bn(p, f"{prefix}.downsample.1"))
    return torch.relu(y + identity)


def _basic_block_q(qs, x, p, prefix, stride):
    y = q.conv_q(qs, f"{prefix}.conv1", x, p, stride, 1,
                 bias=q.affine_from_folded_bn(p, f"{prefix}.bn1")).relu_()
    y = q.conv_q(qs, f"{prefix}.conv2", y, p, 1, 1,
                 bias=q.affine_from_folded_bn(p, f"{prefix}.bn2"))
    identity = x
    if f"{prefix}.downsample.0.weight" in p:
        # 1x1 in stages, 3x3 in the compress grafts (their conv bias is
        # folded into downsample.1's shift)
        pad = (p[f"{prefix}.downsample.0.weight"].shape[-1] - 1) // 2
        identity = q.conv_q(
            qs, f"{prefix}.downsample.0", x, p, stride, pad,
            bias=q.affine_from_folded_bn(p, f"{prefix}.downsample.1"))
    return torch.relu(y + identity)


def apply_int8(params_q, x, spec, scales=None):
    """W8A8 inference path (opt-in; not the parity path).

    params_q: ``quantize_resnet_params(fold_resnet_bn(params))``.
    scales: calibrated activation scales; None calibrates on this batch.
    Returns (out (N, out_size) in x's dtype, scales dict)."""
    qs = q.QuantState(scales)
    y = q.conv_q(qs, "conv1", x, params_q, 2, 3,
                 bias=q.affine_from_folded_bn(params_q, "bn1")).relu_()
    y = cm.max_pool(y, window=3, stride=2, padding=1).contiguous()
    block_q = (_bottleneck_block_q if spec.block == "bottleneck"
               else _basic_block_q)
    for stage_idx in range(4 if spec.cut != "l3" else 3):
        name = f"layer{stage_idx + 1}"
        grafted = _grafted(spec, stage_idx)
        base = f"{name}.0" if grafted else name
        for i in range(spec.layers[stage_idx]):
            stride = 2 if (i == 0 and stage_idx > 0) else 1
            y = block_q(qs, y, params_q, f"{base}.{i}", stride)
        if grafted:
            y = _basic_block_q(qs, y, params_q, f"{name}.1", 1)
    if spec.cut in ("l3", "l4"):
        return cm.flatten_nchw(y), qs.scales
    return y.mean(dim=(1, 2)), qs.scales


# -----------------------------------------------------------------------------
# Initialization (torchvision distributions) — used when no checkpoint.
# The numpy draw order is the JAX package's, so the same seed gives the
# same weights in both packages.
# -----------------------------------------------------------------------------


def _init_bn(out, prefix, ch):
    out[f"{prefix}.weight"] = np.ones(ch, np.float32)
    out[f"{prefix}.bias"] = np.zeros(ch, np.float32)
    out[f"{prefix}.running_mean"] = np.zeros(ch, np.float32)
    out[f"{prefix}.running_var"] = np.ones(ch, np.float32)


def _init_basic(out, rng, prefix, cin, cout, stride, downsample_kernel=None):
    out[f"{prefix}.conv1.weight"] = cm.kaiming_normal_conv(
        rng, (cout, cin, 3, 3))
    _init_bn(out, f"{prefix}.bn1", cout)
    out[f"{prefix}.conv2.weight"] = cm.kaiming_normal_conv(
        rng, (cout, cout, 3, 3))
    _init_bn(out, f"{prefix}.bn2", cout)
    if downsample_kernel is not None:
        k = downsample_kernel
        out[f"{prefix}.downsample.0.weight"] = cm.kaiming_normal_conv(
            rng, (cout, cin, k, k))
        if k == 3:  # compress-graft shortcut conv carries a bias
            out[f"{prefix}.downsample.0.bias"] = cm.uniform_fan_in(
                rng, (cout,), cin * k * k)
        _init_bn(out, f"{prefix}.downsample.1", cout)


def _init_bottleneck(out, rng, prefix, cin, planes, stride):
    cout = planes * 4
    out[f"{prefix}.conv1.weight"] = cm.kaiming_normal_conv(
        rng, (planes, cin, 1, 1))
    _init_bn(out, f"{prefix}.bn1", planes)
    out[f"{prefix}.conv2.weight"] = cm.kaiming_normal_conv(
        rng, (planes, planes, 3, 3))
    _init_bn(out, f"{prefix}.bn2", planes)
    out[f"{prefix}.conv3.weight"] = cm.kaiming_normal_conv(
        rng, (cout, planes, 1, 1))
    _init_bn(out, f"{prefix}.bn3", cout)
    if stride != 1 or cin != cout:
        out[f"{prefix}.downsample.0.weight"] = cm.kaiming_normal_conv(
            rng, (cout, cin, 1, 1))
        _init_bn(out, f"{prefix}.downsample.1", cout)


def _init_numpy(spec, rng):
    out = {}
    out["conv1.weight"] = cm.kaiming_normal_conv(rng, (64, 3, 7, 7))
    _init_bn(out, "bn1", 64)

    cin = 64
    exp = EXPANSION[spec.block]
    for stage_idx, planes in enumerate((64, 128, 256, 512)):
        if spec.cut == "l3" and stage_idx == 3:
            break
        name = f"layer{stage_idx + 1}"
        grafted = _grafted(spec, stage_idx)
        base = f"{name}.0" if grafted else name
        for i in range(spec.layers[stage_idx]):
            stride = 2 if (i == 0 and stage_idx > 0) else 1
            if spec.block == "basic":
                ds = 1 if (stride != 1 or cin != planes) else None
                _init_basic(out, rng, f"{base}.{i}", cin, planes, stride, ds)
                cin = planes
            else:
                _init_bottleneck(out, rng, f"{base}.{i}", cin, planes, stride)
                cin = planes * exp
        if grafted:
            _init_basic(out, rng, f"{name}.1", spec.compress_in,
                        spec.compress_out, 1, downsample_kernel=3)
    return out


def init_params(spec, rng, device=None):
    """Freshly initialized flat params (OIHW f32 tensors) for ``spec``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in _init_numpy(spec, rng).items()}
