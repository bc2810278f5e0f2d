"""BatchNorm folding for frozen-encoder inference (counterpart of
``pvr_habitat_tpu/ops/fold_bn.py``).

Eval-mode BN is an affine map per channel; folding it into the
preceding conv removes the elementwise pass.  BN params are replaced IN
PLACE by identity-shaped ones so the unmodified apply code keeps
working:

    w'   = w * gamma * rsqrt(var + eps)        (per output channel)
    bn'  = weight=1, bias = beta - mean * s, mean=0, var = 1 - eps
           (so rsqrt(var+eps) == 1)

Conv weights are OIHW here, so the scale broadcasts over dim 0 (the JAX
package's HWIO weights take it over the last dim).

Only valid for frozen encoders."""

import re

import torch

BN_EPS = 1e-5

_CONV_FOR_BN = [
    # (bn key regex, conv key builder)
    (re.compile(r"^(?P<base>.*\.)?bn(?P<i>\d)$"),
     lambda m: f"{m.group('base') or ''}conv{m.group('i')}"),
    (re.compile(r"^(?P<base>.*\.)?downsample\.1$"),
     lambda m: f"{m.group('base') or ''}downsample.0"),
    (re.compile(r"^bn1$"), lambda m: "conv1"),
    # detectron2 naming: '<conv>.norm.*' FrozenBN attached to '<conv>.weight'
    (re.compile(r"^(?P<conv>.*)\.norm$"), lambda m: m.group("conv")),
]


def fold_resnet_bn(params):
    """Fold every (convN, bnN) / (downsample.0, downsample.1) pair of a
    flat ResNet param dict.  Returns a new flat dict."""
    out = dict(params)
    bn_prefixes = sorted({
        key[: -len(".running_mean")]
        for key in params if key.endswith(".running_mean")
    })
    for bn in bn_prefixes:
        conv = None
        for pattern, builder in _CONV_FOR_BN:
            match = pattern.match(bn)
            if match and f"{builder(match)}.weight" in params:
                conv = builder(match)
                break
        if conv is None:
            continue
        gamma = params[f"{bn}.weight"]
        beta = params[f"{bn}.bias"]
        mean = params[f"{bn}.running_mean"]
        var = params[f"{bn}.running_var"]
        scale = gamma / torch.sqrt(var + BN_EPS)
        weight = params[f"{conv}.weight"]
        out[f"{conv}.weight"] = weight * scale.reshape(
            (-1,) + (1,) * (weight.dim() - 1))      # OIHW: O first
        conv_bias = params.get(f"{conv}.bias")
        shift = beta - mean * scale
        if conv_bias is not None:
            shift = shift + conv_bias * scale
            out[f"{conv}.bias"] = torch.zeros_like(conv_bias)
        out[f"{bn}.weight"] = torch.ones_like(gamma)
        out[f"{bn}.bias"] = shift
        out[f"{bn}.running_mean"] = torch.zeros_like(mean)
        out[f"{bn}.running_var"] = torch.full_like(var, 1.0 - BN_EPS)
    return out
