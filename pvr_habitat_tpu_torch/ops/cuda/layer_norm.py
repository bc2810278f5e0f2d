"""LayerNorm over the last axis for the ViT encoders: the Hopper kernel and
its plain PyTorch version.

``layer_norm`` launches ``csrc/layer_norm.cu``, whose header says what
bounds it on the card and how the design answers it.  It replaces no
Pallas kernel: the JAX package leaves LayerNorm to XLA's fusion.
``models/common.py::layer_norm`` calls it for every encoder.

A wrapper runs the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; it never falls back.  The
kernel takes x in float32 or bfloat16 with a width in ``WIDTHS`` (every
ViT of the zoo: 768, 1024, 1280), and w and b in float32 or x's dtype.
Each launch adds one to ``launches["layer_norm"]``.  Each call is a
``kernel.layer_norm`` span (``utils/profiling.py``) with the call's
``shape`` (``layer_norm_shape``).  The kernel has no backward: a call that
autograd would have to differentiate raises rather than cut the graph.
"""

import functools

import torch

from pvr_habitat_tpu_torch.utils.profiling import span

launches = {"layer_norm": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Widths the kernel takes, those of the zoo's ViTs: 32 lanes of 24, 32 or
# 40 values, whole 16-byte vectors in both dtypes.
WIDTHS = (768, 1024, 1280)


def reset_launches():
    launches["layer_norm"] = 0


# -----------------------------------------------------------------------------
# Plain version (what runs on the CPU; the reference on the card)
# -----------------------------------------------------------------------------


def layer_norm_ref(x, w, b, eps=1e-6):
    """LayerNorm over the last axis with the JAX package's rounding points:
    the mean and the biased variance accumulate in f32 and are rounded to
    x's dtype, then ``(x - mean) * rsqrt(var + eps)`` runs in x's dtype
    with eps rounded to it (``F.layer_norm`` would stay in f32).  The rsqrt
    is taken in f32 and rounded once, as XLA takes it (torch's bf16 rsqrt
    on the CPU rounds the sqrt first)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(dt)
    var = xf.var(dim=-1, unbiased=False, keepdim=True).to(dt)
    inv = torch.rsqrt((var + torch.tensor(eps, dtype=dt)).float()).to(dt)
    y = (x - mean) * inv
    return y * w.to(dt) + b.to(dt)


# -----------------------------------------------------------------------------
# Kernel
# -----------------------------------------------------------------------------


def layer_norm(x, w, b, eps=1e-6):
    """x: (..., D); w, b: (D,).  Returns x's shape and dtype, dense."""
    with span("kernel.layer_norm", shape=lambda: layer_norm_shape(x)):
        if x.device.type == "cpu":
            return layer_norm_ref(x, w, b, eps)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return _launch(x, w, b, eps)


def layer_norm_shape(x):
    """What a call's bytes follow from: rows, width, item size, dtype."""
    d = x.shape[-1] if x.dim() else 1
    return dict(rows=x.numel() // max(d, 1), d=d,
                itemsize=x.element_size(), dtype=str(x.dtype)[6:])


def kernel_rows(x, w, b):
    """The (rows, D) tensor the kernel reads for ``x``: a view where D's
    stride is 1 and every row starts on 16 bytes, else a dense copy.
    Raises ValueError for what the kernel does not take, and for a call
    that autograd would differentiate (the kernel has no backward)."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if x.dim() == 0 or x.shape[-1] not in WIDTHS:
        raise ValueError(f"width {tuple(x.shape)[-1:]} is not one of "
                         f"{WIDTHS}")
    d = x.shape[-1]
    for name, t in (("w", w), ("b", b)):
        if t.shape != (d,):
            raise ValueError(f"{name}: expected ({d},), got {tuple(t.shape)}")
        if t.dtype not in (torch.float32, x.dtype) or t.dtype != w.dtype:
            raise ValueError(f"{name}: {t.dtype} for x in {x.dtype}; w and "
                             f"b take float32 or x's dtype, both the same")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        raise ValueError("the kernel has no backward: call it under "
                         "torch.no_grad() or on tensors that need no grad")
    rows = x.reshape(-1, d)
    size = x.element_size()
    if (rows.stride(1) != 1 or rows.data_ptr() % 16
            or (rows.shape[0] > 1 and rows.stride(0) * size % 16)):
        rows = rows.contiguous()
    return rows


@functools.lru_cache(maxsize=None)
def _eps(eps, dtype):
    """eps rounded to ``dtype``, as the plain version rounds it."""
    return float(torch.tensor(eps, dtype=dtype))


def _launch(x, w, b, eps):
    rows = kernel_rows(x, w, b)
    w, b = w.contiguous(), b.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    from pvr_habitat_tpu_torch.ops.cuda import build

    lib = build.load("layer_norm")
    with torch.cuda.device(x.device):
        err = lib.layer_norm_launch(
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], rows.data_ptr(),
            rows.stride(0), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            rows.shape[0], x.shape[-1], _eps(eps, x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"layer_norm launch failed: "
                           f"{lib.layer_norm_error_string(err).decode()}")
    launches["layer_norm"] += 1
    return out
