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

from pvr_habitat_tpu_torch.ops.cuda import layer_norm as ln


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
    """NHWC k x k average pool at stride k, VALID (CLIP's ``AvgPool2d(k)``).
    The window is summed in x's dtype in row-major order and then divided
    by k*k, as the JAX package's ``reduce_window`` sums it: in bf16 each
    add rounds (``F.avg_pool2d`` would sum in f32)."""
    h, w = x.shape[1] // k * k, x.shape[2] // k * k
    total = x[:, 0:h:k, 0:w:k]
    for i in range(k):
        for j in range(k):
            if i or j:
                total = total + x[:, i:h:k, j:w:k]
    return total / (k * k)


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
    """LayerNorm over the last axis with the weight and bias under
    ``prefix``: ``ops/cuda/layer_norm.py``'s kernel on the card, its plain
    version (the JAX package's rounding points) on the CPU."""
    return ln.layer_norm(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"], eps)


def gelu(x):
    """torch.nn.GELU's exact erf in f32 (the parity path); the tanh
    approximation in bf16, as in the JAX package."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


def gelu_tanh_stepwise(x):
    """``jax.nn.gelu(x, approximate=True)`` op by op, as XLA runs it on the
    CPU: every step of ``x * 0.5 * (1 + tanh(c1 * (x + c2 * x**3)))``
    rounds to x's dtype, with c1 = sqrt(2/pi) and c2 = 0.044715 rounded
    to it too.  In bf16 that differs from ``F.gelu``'s single rounding in
    about 45% of the elements; the int8 ViT block, whose next layer
    quantizes the result, takes this form.  Eight elementwise passes."""
    dt = x.dtype
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=dt)
    c2 = torch.tensor(0.044715, dtype=dt)
    t = x * x
    t.mul_(x).mul_(c2).add_(x).mul_(c1).tanh_().add_(1.0)
    # 0.5 * (1 + tanh) rounds exactly as (1 + tanh) did, so the halving
    # folds into the last product: x * t * 0.5, one rounding
    return torch.addcmul(x.new_zeros(()), x, t, value=0.5)


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
