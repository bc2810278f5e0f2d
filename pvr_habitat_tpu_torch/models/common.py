"""Shared functional NN primitives (counterpart of
``pvr_habitat_tpu/models/common.py``).

Conventions:
- Activations are NHWC at every public function, as in the JAX package,
  so the tests compare like with like.  ``x.permute(0, 3, 1, 2)`` of a
  contiguous NHWC tensor is a channels_last NCHW view, so ``F.conv2d``
  takes it without a copy and returns channels_last, whose inverse
  permute is contiguous NHWC again.
- Conv weights are OIHW, PyTorch's own layout; ``models/convert.py``
  bridges them to the JAX package's HWIO.
- Parameters live in a FLAT dict keyed by the PyTorch module path of the
  reference model (e.g. ``layer1.0.conv1.weight``), the same keys as the
  JAX package, so a flat dict is also a torch state dict.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x, w, stride=1, padding=0, bias=None):
    """NHWC conv with OIHW weights and symmetric integer padding."""
    if bias is not None:
        bias = bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), bias, stride, padding)
    return y.permute(0, 2, 3, 1)


def batch_norm(x, p, prefix, eps=1e-5, train=False):
    """BatchNorm with torch semantics on NHWC.

    Eval mode normalizes by running stats.  Train mode normalizes by
    biased batch stats; running-stat updates are the caller's.
    """
    gamma = p[f"{prefix}.weight"].to(x.dtype)
    beta = p[f"{prefix}.bias"].to(x.dtype)
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
    else:
        mean = p[f"{prefix}.running_mean"].to(x.dtype)
        var = p[f"{prefix}.running_var"].to(x.dtype)
    inv = torch.rsqrt(var + eps)
    return (x - mean) * (inv * gamma) + beta


def linear(x, p, prefix):
    """torch nn.Linear: weight (out, in), y = x @ w.T + b."""
    y = x @ p[f"{prefix}.weight"].to(x.dtype).T
    b = p.get(f"{prefix}.bias")
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def max_pool(x, window=3, stride=2, padding=1):
    """NHWC max pool; the implicit padding is -inf, as in the JAX
    package's ``reduce_window`` with an -inf init."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool(x, k):
    """NHWC k x k average pool at stride k, VALID (CLIP's ``AvgPool2d(k)``;
    the JAX package sums with ``reduce_window`` and divides by k*k)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, k)
    return y.permute(0, 2, 3, 1)


def sub(params, prefix):
    """View of a flat param dict under a key prefix."""
    pre = prefix + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def add_prefix(params, prefix):
    return {f"{prefix}.{k}": v for k, v in params.items()}


def flatten_nchw(y):
    """(N, H, W, C) -> (N, C*H*W) in torch's NCHW order."""
    return y.permute(0, 3, 1, 2).reshape(y.shape[0], -1)


def layer_norm(x, p, prefix, eps=1e-6):
    """LayerNorm over the last axis with the JAX package's rounding points:
    the mean and the biased variance accumulate in f32 and are rounded to
    x's dtype, then ``(x - mean) * rsqrt(var + eps)`` runs in x's dtype
    with eps rounded to it (``F.layer_norm`` would stay in f32)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(dt)
    var = xf.var(dim=-1, unbiased=False, keepdim=True).to(dt)
    y = (x - mean) * torch.rsqrt(var + torch.tensor(eps, dtype=dt))
    return y * p[f"{prefix}.weight"].to(dt) + p[f"{prefix}.bias"].to(dt)


def gelu(x):
    """torch.nn.GELU's exact erf in f32 (the parity path); the tanh
    approximation in bf16, as in the JAX package."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


# -----------------------------------------------------------------------------
# Initializers replicating torch distributions (numpy, host-side).  They
# draw the same numpy stream as the JAX package's, and return PyTorch's
# OIHW where the JAX package returns HWIO.
# -----------------------------------------------------------------------------


class ShapeRNG:
    """Stands in for ``np.random.RandomState`` where only an init's keys
    and shapes are wanted (a checkpoint's expected names): it draws
    zeros, so it skips the draws' cost."""

    @staticmethod
    def normal(loc=0.0, scale=1.0, size=None):
        return np.zeros(size, np.float32)

    uniform = normal


def kaiming_normal_conv(rng, shape_oihw):
    """torch kaiming_normal_(mode='fan_out', nonlinearity='relu') on an
    OIHW conv weight."""
    o, i, kh, kw = shape_oihw
    fan_out = o * kh * kw
    std = math.sqrt(2.0 / fan_out)
    return rng.normal(0.0, std, size=shape_oihw).astype(np.float32)


def orthogonal(rng, shape_out_in, gain=1.0):
    """torch nn.init.orthogonal_ on a (out, in) matrix."""
    rows, cols = shape_out_in
    flat = rng.normal(0.0, 1.0, size=(max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(flat)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return (gain * q[:rows, :cols]).astype(np.float32)


def orthogonal_conv(rng, shape_oihw, gain=math.sqrt(2.0)):
    """torch orthogonal_ flattens trailing dims: (O, I*kh*kw); OIHW out."""
    o, i, kh, kw = shape_oihw
    return orthogonal(rng, (o, i * kh * kw), gain).reshape(o, i, kh, kw)


def uniform_fan_in(rng, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)
