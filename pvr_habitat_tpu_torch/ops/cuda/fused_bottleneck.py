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
main path went through the kernels, and leaves its launch shape in
``last_launch[<kernel>]``.  Each ``fused_bottleneck`` call is a
``kernel.fused_bottleneck`` span (``utils/profiling.py``) with the call's
``shape`` (``block_shape``).

Launch shape: ``pick_launch`` chooses a launch's output tile and, in
f32, how many blocks (a thread-block cluster) split each tile's
channels, from the batch and the card's SM count.  The f32 engine serves
the eval batches of 1 and 4 images, where one block a tile left most of
the card idle (a batch-1 forward's 16 launches: 11.70 ms before the
split, 4.17 after; H100 80GB HBM3 at 700 W, PERF.md).
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pvr_habitat_tpu_torch.utils.profiling import span

launches = {"fused_bottleneck": 0, "fused_bottleneck_flat": 0}
# (tile, cluster, blocks) of each kernel's last launch
last_launch = {"fused_bottleneck": None, "fused_bottleneck_flat": None}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may use on Hopper (sm_90: 227 KB of the 228 KB).
MAX_SMEM = 232448
SMEM_PER_SM = 233472
_TILES = (14, 8, 7, 4, 2, 1)
_PAD = 8  # shared-memory row pitch is P + 8 (kPad in the .cu)
# The least weight ring of the bf16 kernel, after y1 and y2: two chunks of
# 32 weight rows at pitch 256 + 8 (kRingBytes in the .cu, which grows the
# ring into the shared memory that the block's occupancy leaves free).
RING_BYTES = 2 * 32 * (256 + _PAD) * 2
# Rows of one job: a bf16 warp's 2 x 16 MMA rows, an f32 thread's 8.
_JOB_ROWS = {2: 32, 4: 8}
_F32_JOB_COLS = 4  # channels of an f32 thread's job (RN in the .cu)
_THREADS = 256     # threads a block (kThreads in the .cu)
# Blocks of an f32 cluster that split a tile's channels; 8 is the most a
# cluster may have without the non-portable attribute.
_CLUSTERS = (1, 2, 4, 8)


def reset_launches():
    for key in launches:
        launches[key] = 0
        last_launch[key] = None


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


def smem_bytes(t, stride, p, itemsize):
    """Shared memory of one block at tile side ``t``: y1 on the halo and
    y2 at pitch P + 8, and in bf16 the weight ring."""
    hs = (t - 1) * stride + 3
    ring = RING_BYTES if itemsize == 2 else 0
    return (hs * hs + t * t) * (p + _PAD) * itemsize + ring


def pick_tile(ho, stride, cin, p, cout, has_downsample, itemsize):
    """Output tile side T for one block: the least FLOP including conv1's
    halo recompute, the ragged edge and the rows that pad each stage to
    whole jobs, among the tiles whose shared memory (``smem_bytes``) fits;
    a tile too large for two blocks per SM pays a quarter more.  A first
    guess, to be tuned on the card."""

    def rows(m):
        return math.ceil(m / _JOB_ROWS[itemsize]) * _JOB_ROWS[itemsize]

    best = None
    for t in _TILES:
        if t > ho:
            continue
        hs = (t - 1) * stride + 3
        smem = smem_bytes(t, stride, p, itemsize)
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


def launch_shapes(ho, stride, p, cout, itemsize):
    """Every (tile, cluster) that a launch at output side ``ho`` may take:
    the tiles whose shared memory fits (``smem_bytes``; a cluster does not
    change it, since each block holds the whole y1 halo and y2 tile) and,
    in f32, each cluster size whose slices of P and Cout are whole
    4-channel jobs; in bf16 cluster 1 only."""
    clusters = _CLUSTERS if itemsize == 4 else (1,)
    return [(t, c) for t in _TILES
            if t <= ho and smem_bytes(t, stride, p, itemsize) <= MAX_SMEM
            for c in clusters
            if p % (_F32_JOB_COLS * c) == 0
            and cout % (_F32_JOB_COLS * c) == 0]


def launch_cost(tile, cluster, ho, stride, cin, p, cout, has_downsample, n,
                sms, max_clusters=None):
    """``pick_launch``'s model of an f32 launch over ``n`` images at
    (tile, cluster), as a key to minimise: (waves x the time of one
    block, padded FMAs over the grid, -blocks).

    A block's time is counted in rounds of its 256 threads over each
    stage's jobs (8 rows by 4 of the block's 1/C of the channels; rows
    padded to whole jobs, the halo included), each round a chain of K
    FMAs: a round is bound by the latency of that chain (one L2 load of
    weights a 4-deep step), not by how many threads share it.  The waves
    are the blocks over the SMs, one block an SM at a time (ptxas gives
    the engine over 200 registers a thread: one 256-thread block an SM),
    counted in whole clusters: ``max_clusters(c, smem_bytes)``, where
    given, is how many clusters of c such blocks the card holds at once
    (one GPC holds a cluster).  Ties go to the fewer padded FMAs, then
    to more blocks (fewer jobs a block share an SM's instruction slots)."""
    rows, t, c = _JOB_ROWS[4], tile, cluster
    hs = (t - 1) * stride + 3
    stages = [(hs * hs, p, cin), (t * t, p, 9 * p),
              (t * t, cout, p + (cin if has_downsample else 0))]
    jobs = [math.ceil(m / rows) * (ch // c // _F32_JOB_COLS)
            for m, ch, _ in stages]
    block = sum(math.ceil(j / _THREADS) * k
                for j, (_, _, k) in zip(jobs, stages))
    blocks = math.ceil(ho / t) ** 2 * c * n
    fit = sms // c
    if max_clusters is not None:
        fit = min(fit, max_clusters(c, smem_bytes(t, stride, p, 4)))
    if not fit:
        return (math.inf,)
    work = blocks * sum(j * k for j, (_, _, k) in zip(jobs, stages))
    return math.ceil(blocks / (fit * c)) * block, work, -blocks


def pick_launch(ho, stride, cin, p, cout, has_downsample, itemsize, n, sms,
                max_clusters=None):
    """(tile, cluster) of one launch over ``n`` images on a card of
    ``sms`` SMs.

    bf16, and f32 whenever ``pick_tile``'s grid gives every SM a block
    (tiles * n >= sms, as at the bulk embedder's batch 32): that tile
    with cluster 1.  Otherwise (f32 at the eval batches) the shape of
    ``launch_shapes`` of least ``launch_cost``."""
    tile = pick_tile(ho, stride, cin, p, cout, has_downsample, itemsize)
    if itemsize != 4 or math.ceil(ho / tile) ** 2 * n >= sms:
        return tile, 1
    return min(launch_shapes(ho, stride, p, cout, itemsize),
               key=lambda tc: launch_cost(*tc, ho, stride, cin, p, cout,
                                          has_downsample, n, sms,
                                          max_clusters))


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


@functools.lru_cache(maxsize=None)
def max_clusters(lib, device, flat, cluster, smem):
    """How many clusters of ``cluster`` f32 blocks of ``smem`` bytes the
    card ``device`` (an index) holds at once, by
    ``cudaOccupancyMaxActiveClusters``."""
    with torch.cuda.device(device):
        count = lib.fused_bottleneck_max_clusters(int(flat), cluster, smem)
    if count < 0:
        raise RuntimeError("cudaOccupancyMaxActiveClusters failed: "
                           + lib.fused_bottleneck_error_string(-count)
                           .decode())
    return count


@functools.lru_cache(maxsize=None)
def _pick(lib, device, flat, ho, stride, cin, p, cout, has_downsample,
          itemsize, n):
    """``pick_launch`` on the card ``device`` (an index), with its SM count
    and cluster occupancy; kept per shape, so a launch pays no search."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return pick_launch(
        ho, stride, cin, p, cout, has_downsample, itemsize, n, sms,
        lambda c, smem: max_clusters(lib, device, flat, c, smem))


def _record(name, ho, wo, n, tile, cluster):
    launches[name] += 1
    last_launch[name] = (tile, cluster, math.ceil(ho / tile)
                         * math.ceil(wo / tile) * cluster * n)


def block_shape(x, w1, w3, wd, stride):
    """What a block's operations and bytes follow from: batch, input
    side, stride, widths, projection, item size and dtype."""
    return dict(n=x.shape[0], h=x.shape[1], stride=stride, cin=x.shape[3],
                p=w1.shape[1], cout=w3.shape[1], ds=wd is not None,
                itemsize=x.element_size(), dtype=str(x.dtype)[6:])


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None, stride=1,
                     lib=None):
    """x: (N, H, W, Cin) f32 or bf16.  w1 (Cin, P), w2 (9, P, P), w3
    (P, Cout), wd (Cin, Cout) or None, in x's dtype; biases f32.
    Returns (N, H/s, W/s, Cout).  ``lib`` exists only for
    ``tools/bottleneck_variants.py``, which launches other builds of the
    kernel (``build.load`` with a source of its own) to time them against
    the tree's; every other caller leaves it unset."""
    with span("kernel.fused_bottleneck",
              shape=lambda: block_shape(x, w1, w3, wd, stride)):
        if x.device.type == "cpu":
            return fused_bottleneck_ref(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                        stride)
        return _launch(x, w1, b1, w2, b2, w3, b3, wd, bd, stride, lib)


def _launch(x, w1, b1, w2, b2, w3, b3, wd, bd, stride, lib, shape=None):
    """``fused_bottleneck`` on the card at the launch shape ``(tile,
    cluster)``, or at ``pick_launch``'s where it is None."""
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
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)

    if lib is None:
        from pvr_habitat_tpu_torch.ops.cuda import build

        lib = build.load("fused_bottleneck")
    tile, cluster = shape or _pick(
        lib, x.device.index, False, max(ho, wo), stride, cin, p, cout,
        wd is not None, x.element_size(), n)
    with torch.cuda.device(x.device):
        err = lib.fused_bottleneck_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            _ptr(wd), _ptr(bd), out.data_ptr(), n, h, w_, cin, p, cout,
            stride, tile, cluster,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "fused_bottleneck")
    _record("fused_bottleneck", ho, wo, n, tile, cluster)
    return out


def fused_bottleneck_flat(x_flat, mask, w1, b1, w2, b2, w3, b3, wd=None,
                          bd=None, *, h, w, lib=None):
    """Stride-1 fused bottleneck over padded-flat activations.

    x_flat: (N, (H+2)(W+2), Cin) with zeroed borders; mask (PHW, 1) f32
    from ``flat_mask``.  Returns the same layout with Cout channels and a
    zero border.  ``lib`` as for ``fused_bottleneck``."""
    if x_flat.device.type == "cpu":
        return fused_bottleneck_flat_ref(x_flat, mask, w1, b1, w2, b2, w3,
                                         b3, wd, bd, h=h, w=w)
    return _launch_flat(x_flat, mask, w1, b1, w2, b2, w3, b3, wd, bd, h, w,
                        lib)


def _launch_flat(x_flat, mask, w1, b1, w2, b2, w3, b3, wd, bd, h, w, lib,
                 shape=None):
    """``fused_bottleneck_flat`` on the card, as ``_launch``."""
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
    out = torch.empty((n, phw, cout), dtype=x_flat.dtype,
                      device=x_flat.device)

    if lib is None:
        from pvr_habitat_tpu_torch.ops.cuda import build

        lib = build.load("fused_bottleneck")
    tile, cluster = shape or _pick(
        lib, x_flat.device.index, True, max(h, w), 1, cin, p, cout,
        wd is not None, x_flat.element_size(), n)
    with torch.cuda.device(x_flat.device):
        err = lib.fused_bottleneck_flat_launch(
            _DTYPE_CODE[x_flat.dtype], x_flat.data_ptr(), mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), _ptr(wd), _ptr(bd), out.data_ptr(),
            n, h, w, cin, p, cout, tile, cluster,
            torch.cuda.current_stream(x_flat.device).cuda_stream)
    _raise_on(lib, err, "fused_bottleneck_flat")
    _record("fused_bottleneck_flat", h, w, n, tile, cluster)
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
