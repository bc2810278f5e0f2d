"""Fused multi-head attention for the ViT encoders: the Hopper kernel, its
plain PyTorch version, and the routing rule of the call sites.

``fused_attention`` replaces
``pvr_habitat_tpu/ops/pallas/attention.py::fused_attention`` and launches
``csrc/fused_attention.cu``, whose header says what bounds it on the card
and how the design answers it.

Routing.  The port reads none of the JAX package's attention environment
switches (``PVR_TPU_ATTENTION_CORE``, ``PVR_TPU_ENABLE_PALLAS_ATTENTION``,
``PVR_TPU_DISABLE_PALLAS_ATTENTION``): the route is the explicit ``fused``
argument of the encoder, as it is for the ResNet blocks.  ``fused="off"``
runs the einsum core of ``models/vit.py``; ``fused="attention"`` sends
every call that meets the JAX package's condition (``kernel_applies``:
bf16 and L >= 128) through ``fused_attention``.  The JAX package's
``flash`` core wraps JAX's stock TPU kernel, which this repo did not
write, and has no counterpart.

A wrapper runs the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; it never falls back.  Each
launch adds one to ``launches["fused_attention"]``.  Each call is a
``kernel.fused_attention`` span (``utils/profiling.py``) with the call's
``shape`` (``attention_shape``).
"""

import ctypes
import math

import torch

from pvr_habitat_tpu_torch.utils.profiling import span

launches = {"fused_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may use on Hopper (sm_90: 227 KB of the 228 KB).
MAX_SMEM = 232448
MAX_HEAD_DIM = 128
MIN_KERNEL_TOKENS = 128   # the JAX call sites' L >= 128 (vit.py:81-82)


def reset_launches():
    for key in launches:
        launches[key] = 0


def kernel_applies(dtype, length):
    """Whether a ``fused="attention"`` call site sends a core of this
    dtype and sequence length to the kernel: bf16 with L >= 128, the
    JAX package's condition.  MAE (L = 197, 257) qualifies; CLIP ViT-B/32
    (L = 50) and every f32 call take the einsum core."""
    return dtype == torch.bfloat16 and length >= MIN_KERNEL_TOKENS


# -----------------------------------------------------------------------------
# Plain version (what runs on the CPU; the reference on the card)
# -----------------------------------------------------------------------------


def fused_attention_ref(q, k, v):
    """q, k, v: (N, H, L, D) -> (N, H, L, D) in q's dtype, with the TPU
    kernel's rounding points: f32 scores times 1/sqrt(D), f32 softmax,
    p rounded to q's dtype, p . v accumulated in f32."""
    dt = q.dtype
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return (p.float() @ v.float()).to(dt)


# -----------------------------------------------------------------------------
# Kernel
# -----------------------------------------------------------------------------


def _kernel_layout(t):
    """``t`` if the kernel can read it in place (D's stride 1, rows and
    base 16-byte aligned), else a contiguous copy."""
    size = t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * size % 16 == 0 for i in range(3))):
        return t
    return t.contiguous()


def fused_attention(q, k, v, lib=None):
    """q, k, v: (N, H, L, D), f32 or bf16, any strides with D's stride 1.
    Returns (N, H, L, D) in q's dtype.  On the card the result's memory
    is (N, L, H, D), so ``out.transpose(1, 2).reshape(N, L, H * D)`` is a
    view.  ``lib`` exists only for ``tools/attention_tilings.py``, which
    launches other builds of the kernel (``build.load`` with a source of
    its own) to time them against the tree's; every other caller leaves
    it unset."""
    with span("kernel.fused_attention", shape=lambda: attention_shape(q)):
        return _attention(q, k, v, lib)


def attention_shape(q):
    """What a call's operations and bytes follow from: batch, heads,
    length, head size, item size and dtype."""
    n, h, l, d = q.shape
    return dict(n=n, h=h, l=l, d=d, itemsize=q.element_size(),
                dtype=str(q.dtype)[6:])


def _attention(q, k, v, lib):
    if q.device.type == "cpu":
        return fused_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (N, H, L, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: expected {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype}")
    n, h, l, d = q.shape
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if not (n <= 65535 and h <= 65535):
        raise ValueError(f"batch {n} or heads {h} above 65535")
    out = torch.empty((n, l, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out

    if lib is None:
        from pvr_habitat_tpu_torch.ops.cuda import build

        lib = build.load("fused_attention")
    code = _DTYPE_CODE[q.dtype]
    smem = lib.fused_attention_smem_bytes(code, l, d)
    if smem > MAX_SMEM:
        raise ValueError(f"L={l}, D={d} in {q.dtype} needs {smem} B of "
                         f"shared memory, above {MAX_SMEM}")
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.fused_attention_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, n, h, l, d, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_attention launch failed: "
                           f"{lib.fused_attention_error_string(err).decode()}")
    launches["fused_attention"] += 1
    return out
