"""Fused BN-folded ResNet bottleneck blocks: the Hopper kernels, their
plain PyTorch versions, and the helpers around them.

``fused_bottleneck`` replaces
``pvr_habitat_tpu/ops/pallas/fused_bottleneck.py::fused_bottleneck``
(v1, NHWC) and ``fused_bottleneck_flat`` replaces ``::fused_bottleneck_flat``
(v2, padded-flat).  Both launch ``csrc/fused_bottleneck.cu``, whose header
says what bounds each block on the card and how the design answers it.

A wrapper runs the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; it never falls back.  Each
launch adds one to ``launches[<kernel>]``, so a run can show that its
main path went through the kernels.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

launches = {"fused_bottleneck": 0, "fused_bottleneck_flat": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may use on Hopper (sm_90: 227 KB of the 228 KB).
MAX_SMEM = 232448
SMEM_PER_SM = 233472
_TILES = (14, 8, 7, 4, 2, 1)
_PAD = 8  # shared-memory row pitch is P + 8 (kPad in the .cu)
# Rows of one job: a bf16 warp's 2 x 16 MMA rows, an f32 thread's 8.
_JOB_ROWS = {2: 32, 4: 8}


def reset_launches():
    for key in launches:
        launches[key] = 0


# -----------------------------------------------------------------------------
# Plain versions (what runs on the CPU; the reference on the card)
# -----------------------------------------------------------------------------


def _as_conv1x1(w):
    """(Cin, Cout) matmul weight -> (Cout, Cin, 1, 1) f32 conv weight."""
    return w.float().T[:, :, None, None]


def fused_bottleneck_ref(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None,
                         stride=1):
    """The block as ``F.conv2d`` calls on the ``block_weights`` tensors,
    in f32 with y1 and y2 rounded to x's dtype, like the kernel."""
    dt = x.dtype
    p = w1.shape[1]
    xf = x.permute(0, 3, 1, 2).float()
    y1 = F.relu(F.conv2d(xf, _as_conv1x1(w1), b1)).to(dt).float()
    w2o = w2.float().reshape(3, 3, p, p).permute(3, 2, 0, 1)  # -> OIHW
    y2 = F.relu(F.conv2d(y1, w2o, b2, stride, 1)).to(dt).float()
    y3 = F.conv2d(y2, _as_conv1x1(w3), b3)
    if wd is not None:
        y3 = y3 + F.conv2d(xf, _as_conv1x1(wd), bd, stride)
    else:
        y3 = y3 + xf
    return F.relu(y3).to(dt).permute(0, 2, 3, 1).contiguous()


def fused_bottleneck_flat_ref(x_flat, mask, w1, b1, w2, b2, w3, b3, wd=None,
                              bd=None, *, h, w):
    """The TPU kernel's algorithm over the padded-flat layout: taps are
    row offsets dh*(W+2)+dw, the mask re-zeroes the pads, and the output
    border is zero."""
    dt = x_flat.dtype
    n, phw, _ = x_flat.shape
    pw = w + 2
    slab, off = h * pw, pw + 1
    x = x_flat.float()
    mask = mask.float().reshape(1, phw, 1)
    y1 = (F.relu(x @ w1.float() + b1) * mask).to(dt).float()
    y1 = F.pad(y1, (0, 0, 0, pw))       # covers the (2,2) tap's overrun
    acc = 0
    for tap in range(9):
        start = (tap // 3) * pw + tap % 3
        acc = acc + y1[:, start:start + slab] @ w2[tap].float()
    y2 = F.relu(acc + b2).to(dt).float()
    xs = x[:, off:off + slab]
    y3 = y2 @ w3.float() + b3
    y3 = y3 + (xs @ wd.float() + bd if wd is not None else xs)
    out = torch.zeros((n, phw, w3.shape[1]), dtype=dt, device=x_flat.device)
    out[:, off:off + slab] = (F.relu(y3) * mask[:, off:off + slab]).to(dt)
    return out


# -----------------------------------------------------------------------------
# Kernels
# -----------------------------------------------------------------------------


def pick_tile(ho, stride, cin, p, cout, has_downsample, itemsize):
    """Output tile side T for one block: the least FLOP including conv1's
    halo recompute, the ragged edge and the rows that pad each stage to
    whole jobs, among the tiles whose halo and y2 fit in shared memory; a
    tile too large for two blocks per SM pays a quarter more.  A first
    guess, to be tuned on the card."""

    def rows(m):
        return math.ceil(m / _JOB_ROWS[itemsize]) * _JOB_ROWS[itemsize]

    best = None
    for t in _TILES:
        if t > ho:
            continue
        hs = (t - 1) * stride + 3
        smem = (hs * hs + t * t) * (p + _PAD) * itemsize
        if smem > MAX_SMEM:
            continue
        tiles = math.ceil(ho / t) ** 2
        work = tiles * (rows(hs * hs) * cin * p + rows(t * t) * (
            9 * p * p + p * cout + (cin * cout if has_downsample else 0)))
        if 2 * (smem + 1024) > SMEM_PER_SM:
            work *= 1.25
        if best is None or work < best[0]:
            best = (work, t)
    if best is None:
        raise ValueError(f"no tile fits: P={p} stride={stride}")
    return best[1]


def _check(name, t, dtype, device, shape=None):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_weights(x, cin, w1, b1, w2, b2, w3, b3, wd, bd):
    dt, dev = x.dtype, x.device
    if dt not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {dt}")
    p, cout = w1.shape[-1], w3.shape[-1]
    # bf16 runs MMAs of depth 16 over Cin and P; every path stores 8 wide
    k_mult = 16 if dt == torch.bfloat16 else 8
    for c, what, mult in ((cin, "Cin", k_mult), (p, "P", k_mult),
                          (cout, "Cout", 8)):
        if c % mult:
            raise ValueError(f"{what}={c} must be a multiple of {mult}")
    _check("w1", w1, dt, dev, (cin, p))
    _check("w2", w2, dt, dev, (9, p, p))
    _check("w3", w3, dt, dev, (p, cout))
    for name, b, size in (("b1", b1, p), ("b2", b2, p), ("b3", b3, cout)):
        _check(name, b, torch.float32, dev, (size,))
    if wd is not None:
        _check("wd", wd, dt, dev, (cin, cout))
        _check("bd", bd, torch.float32, dev, (cout,))
    elif cin != cout:
        raise ValueError("identity shortcut needs Cin == Cout")
    return p, cout


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, err, name):
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.fused_bottleneck_error_string(err).decode()}")


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, stride=1):
    """x: (N, H, W, Cin) f32 or bf16.  w1 (Cin, P), w2 (9, P, P), w3
    (P, Cout), wd (Cin, Cout) or None, in x's dtype; biases f32.
    Returns (N, H/s, W/s, Cout)."""
    if x.device.type == "cpu":
        return fused_bottleneck_ref(x, w1, b1, w2, b2, w3, b3, wd, bd, stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, w_, cin = x.shape
    if stride not in (1, 2) or h % stride or w_ % stride:
        raise ValueError(f"stride {stride} does not divide {h}x{w_}")
    if stride != 1 and wd is None:
        raise ValueError("a strided block needs a projection shortcut")
    if not 0 < n <= 65535:
        raise ValueError(f"batch {n} out of range (1..65535)")
    _check("x", x, x.dtype, x.device)
    p, cout = _check_weights(x, cin, w1, b1, w2, b2, w3, b3, wd, bd)
    ho, wo = h // stride, w_ // stride
    tile = pick_tile(max(ho, wo), stride, cin, p, cout, wd is not None,
                     x.element_size())
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)

    from pvr_habitat_tpu_torch.ops.cuda import build

    lib = build.load("fused_bottleneck")
    with torch.cuda.device(x.device):
        err = lib.fused_bottleneck_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            _ptr(wd), _ptr(bd), out.data_ptr(), n, h, w_, cin, p, cout,
            stride, tile, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "fused_bottleneck")
    launches["fused_bottleneck"] += 1
    return out


def fused_bottleneck_flat(x_flat, mask, w1, b1, w2, b2, w3, b3, wd=None,
                          bd=None, *, h, w):
    """Stride-1 fused bottleneck over padded-flat activations.

    x_flat: (N, (H+2)(W+2), Cin) with zeroed borders; mask (PHW, 1) f32
    from ``flat_mask``.  Returns the same layout with Cout channels and a
    zero border."""
    if x_flat.device.type == "cpu":
        return fused_bottleneck_flat_ref(x_flat, mask, w1, b1, w2, b2, w3,
                                         b3, wd, bd, h=h, w=w)
    if x_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {x_flat.device}")
    if x_flat.dim() != 3:
        raise ValueError(f"x_flat must be (N, PHW, C), got "
                         f"{tuple(x_flat.shape)}")
    n, phw, cin = x_flat.shape
    if phw != (h + 2) * (w + 2):
        raise ValueError(f"{phw} rows is not the padded {h}x{w} plane")
    if not 0 < n <= 65535:
        raise ValueError(f"batch {n} out of range (1..65535)")
    _check("x_flat", x_flat, x_flat.dtype, x_flat.device)
    _check("mask", mask, torch.float32, x_flat.device, (phw, 1))
    p, cout = _check_weights(x_flat, cin, w1, b1, w2, b2, w3, b3, wd, bd)
    tile = pick_tile(max(h, w), 1, cin, p, cout, wd is not None,
                     x_flat.element_size())
    out = torch.empty((n, phw, cout), dtype=x_flat.dtype,
                      device=x_flat.device)

    from pvr_habitat_tpu_torch.ops.cuda import build

    lib = build.load("fused_bottleneck")
    with torch.cuda.device(x_flat.device):
        err = lib.fused_bottleneck_flat_launch(
            _DTYPE_CODE[x_flat.dtype], x_flat.data_ptr(), mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), _ptr(wd), _ptr(bd), out.data_ptr(),
            n, h, w, cin, p, cout, tile,
            torch.cuda.current_stream(x_flat.device).cuda_stream)
    _raise_on(lib, err, "fused_bottleneck_flat")
    launches["fused_bottleneck_flat"] += 1
    return out


# -----------------------------------------------------------------------------
# Layout helpers and weight extraction
# -----------------------------------------------------------------------------


def flat_mask(h, w):
    """(PHW, 1) f32 mask: 1 at interior positions, 0 at pads."""
    m = np.zeros((h + 2, w + 2), np.float32)
    m[1:-1, 1:-1] = 1.0
    return m.reshape(-1, 1)


def to_padded_flat(x):
    """(N, H, W, C) -> (N, (H+2)(W+2), C) with zero borders."""
    n, h, w, c = x.shape
    return F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(n, (h + 2) * (w + 2), c)


def from_padded_flat(x, h, w):
    n, _, c = x.shape
    return x.reshape(n, h + 2, w + 2, c)[:, 1:-1, 1:-1, :]


def block_weights(params, prefix, dtype=torch.bfloat16):
    """Fused-kernel weights for one bottleneck block from a BN-FOLDED flat
    param dict with OIHW conv weights (conv weights scaled, biases in
    '<bn>.bias')."""

    def conv(name):
        return params[f"{prefix}.{name}.weight"]

    def mat(wt):                                      # (O, I, 1, 1) -> (I, O)
        return wt[:, :, 0, 0].T.to(dtype).contiguous()

    w2 = conv("conv2")
    p = w2.shape[0]
    # (O, I, dh, dw) -> (dh, dw, I, O) -> (9, P, P), tap = dh * 3 + dw
    w2 = w2.permute(2, 3, 1, 0).reshape(9, p, p).to(dtype).contiguous()

    def bias(bn):
        return params[f"{prefix}.{bn}.bias"].to(torch.float32).contiguous()

    if f"{prefix}.downsample.0.weight" in params:
        wd, bd = mat(conv("downsample.0")), bias("downsample.1")
    else:
        wd, bd = None, None
    return (mat(conv("conv1")), bias("bn1"), w2, bias("bn2"),
            mat(conv("conv3")), bias("bn3"), wd, bd)
