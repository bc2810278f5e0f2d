"""int8 W8A8 post-training quantization for frozen encoders (counterpart
of ``pvr_habitat_tpu/ops/quantize.py``): the opt-in serving path, held
to cosine gates against f32, not to the 1e-3 parity contract.

Scheme: symmetric, per-output-channel weight scales, per-tensor
activation scales from a one-shot calibration pass.  Activations stay in
their float dtype (bf16 on the serving path) between layers; each conv
or linear quantizes its input, multiplies int8 x int8 -> int32, and
dequantizes with its bias into one rounding to bf16.

Weights keep the port's layouts: OIHW convs and (out, in) linears, so
the per-output-channel axis is 0 for both.

The int8 products.  The JAX package leaves its int8 conv and matmul to
XLA, outside any Pallas kernel, so here they are library products:
a conv is an im2col (one strided copy of the zero-padded NHWC int8
input, in (kh, kw, cin) order, a view for a 1x1 stride-1 conv) times
the weight as (cout, kh*kw*cin), through ``torch._int_mm``.  cuBLAS's
int8 product wants K and N multiples of 8 and M above 16, so the
operands are zero-padded to that (the ResNet stem's K = 147 -> 152),
on the CPU too, so that both devices run the same code.

Rounding points (the JAX package's): ``inv = 1/s_x`` rounded to x's
dtype, ``x * inv`` in x's dtype, round half to even, clip to +-127;
calibration takes ``max(max|x|, 1e-8) / 127`` in x's dtype and stores
it as f32; dequant is ``int32 -> f32 * (s_x * wscale) + bias`` in f32.
"""

import torch

QMAX = 127
MIN_ROWS = 17        # cuBLAS's int8 product wants M > 16
OUT_DTYPE = torch.bfloat16     # what every conv and linear returns


def quantize_weight(w, axis=0):
    """Weight -> (int8 weight, f32 per-output-channel scale along
    ``axis``)."""
    axis = axis % w.dim()
    dims = tuple(i for i in range(w.dim()) if i != axis)
    amax = w.abs().amax(dim=dims)
    scale = amax.clamp_min(1e-8) / 127.0
    shape = [1] * w.dim()
    shape[axis] = -1
    w_q = torch.round(w / scale.reshape(shape)).clamp_(-QMAX, QMAX)
    return w_q.to(torch.int8), scale.float()


def _quantize_keys(params, quantizable):
    out = {}
    for key, value in params.items():
        if quantizable(key, value):
            w_q, scale = quantize_weight(value, axis=0)
            out[key] = w_q
            out[key[:-len(".weight")] + ".wscale"] = scale
        else:
            out[key] = value
    return out


def quantize_resnet_params(params_folded):
    """BN-folded flat ResNet params -> quantized dict: every conv weight
    becomes '<name>.weight' int8 + '<name>.wscale' f32; the folded
    biases and everything else stay as they are."""
    return _quantize_keys(params_folded, lambda key, value: (
        key.endswith(".weight") and value.dim() == 4))


def quantize_vit_params(params):
    """ViT params -> int8 dict: the patch-embed conv and every block
    linear (qkv, proj, mlp) quantize per output channel; LayerNorm
    weights, biases, cls and pos embeddings stay float."""
    return _quantize_keys(params, lambda key, value: (
        key.endswith(".weight") and (
            value.dim() == 4
            or (value.dim() == 2 and (".attn." in key or ".mlp." in key)))))


class QuantState:
    """Carries the activation scales.  ``scales=None`` calibrates: each
    scale is computed from the batch and recorded (a 0-d f32 tensor);
    otherwise the given dict (Python floats or 0-d tensors) is used."""

    def __init__(self, scales=None):
        self.calibrating = scales is None
        self.scales = dict(scales or {})

    def activation_scale(self, name, x):
        """The scale of ``x``: while calibrating a 0-d tensor in x's dtype
        (as the JAX package uses it), else the stored value as a float."""
        if self.calibrating:
            scale = x.abs().amax().clamp_min(1e-8) / 127.0
            self.scales[name] = scale.float()
            return scale
        return float(self.scales[name])


def _inverse(s_x, dtype):
    """1/s_x rounded to ``dtype``: computed in f32 from an f32 scale (a
    float here is an f32 value, and f32(1/s) from float64 is the f32
    quotient), or in x's dtype from a calibrating scale."""
    if isinstance(s_x, torch.Tensor):
        return 1.0 / s_x
    return torch.tensor(1.0 / s_x, dtype=torch.float32).to(dtype)


def quantize_activation(x, s_x, pad=0):
    """x float (N, H, W, C) or (M, K) -> int8 of the same shape, with H and
    W zero-padded by ``pad`` for a 4-D x."""
    q = (x * _inverse(s_x, x.dtype)).round_().clamp_(-QMAX, QMAX)
    if not pad:
        return q.to(torch.int8)
    n, h, w, c = x.shape
    out = torch.zeros((n, h + 2 * pad, w + 2 * pad, c), dtype=torch.int8,
                      device=x.device)
    out[:, pad:pad + h, pad:pad + w].copy_(q)
    return out


def _round_up(n, m):
    return -(-n // m) * m


def matmul_int32(a, w):
    """a (M, K) int8 times w (N, K) int8 transposed -> (M, N) int32,
    through ``torch._int_mm`` with the operands zero-padded to K and N
    multiples of 8 and M > 16."""
    m, k = a.shape
    n = w.shape[0]
    kp, np_, mp = _round_up(k, 8), _round_up(n, 8), max(m, MIN_ROWS)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = torch.nn.functional.pad(w, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(a, w.t())
    return acc[:m, :n] if (mp, np_) != (m, n) else acc


def conv_int32(xp, w_q, stride=1):
    """VALID conv of a zero-padded NHWC int8 ``xp`` with an OIHW int8
    weight -> int32 NHWC: im2col in (kh, kw, cin) order, then
    ``matmul_int32``."""
    n, hp, wp, c = xp.shape
    cout, cin, kh, kw = w_q.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    cols = xp.unfold(1, kh, stride).unfold(2, kw, stride)
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * cin)
    w_mat = w_q.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    return matmul_int32(cols, w_mat).view(n, ho, wo, cout)


def dequantize(acc, scale, bias):
    """int32 -> bf16: acc * scale + bias in f32, rounded once."""
    out = torch.empty(acc.shape, dtype=OUT_DTYPE, device=acc.device)
    return torch.addcmul(bias, acc, scale, out=out)


def conv_q(qs, name, x, params, stride, padding, bias):
    """Quantized conv: x (float NHWC) -> bf16 NHWC."""
    s_x = qs.activation_scale(name, x)
    xp = quantize_activation(x, s_x, padding)
    acc = conv_int32(xp, params[f"{name}.weight"], stride)
    return dequantize(acc, params[f"{name}.wscale"] * s_x, bias)


def linear_q(qs, name, x, params):
    """Quantized torch-style linear: x (M, in) float -> (M, out) bf16."""
    s_x = qs.activation_scale(name, x)
    acc = matmul_int32(quantize_activation(x, s_x), params[f"{name}.weight"])
    return dequantize(acc, params[f"{name}.wscale"] * s_x,
                      params[f"{name}.bias"].float())


def affine_from_folded_bn(params, prefix):
    """After ``fold_resnet_bn`` a BN is ``x * 1 + shift``: its shift as a
    plain f32 bias."""
    return params[f"{prefix}.bias"].float()
