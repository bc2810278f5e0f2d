"""Image preprocessing as two matmuls per frame (counterpart of
``pvr_habitat_tpu/ops/image.py``).

Every resize is expressed as two small matrix products (one per spatial
axis) with precomputed interpolation-weight matrices; the centre crop is
folded into those matrices.  The numerical contracts are the JAX
package's:

- ``bilinear`` (antialias off) matches ``F.interpolate(mode='bilinear',
  align_corners=False)``: half-pixel centers, border clamp.
- ``bicubic`` (antialias off) matches torch's cubic convolution with
  a = -0.75 and border clamp.
- antialias on matches the PIL-style filter of ``antialias=True``: the
  kernel support is scaled by the downscale factor and out-of-range taps
  are dropped and renormalized; cubic uses a = -0.5.
- torchvision's uint8 round-trip: a resized uint8 frame is rounded back
  to uint8 (round-half-to-even, which ``torch.round`` is) before the
  division by 255.
"""

import functools

import numpy as np
import torch


# -----------------------------------------------------------------------------
# Interpolation weight matrices (host-side, tiny, cached)
# -----------------------------------------------------------------------------


def _cubic_kernel(x, a):
    x = np.abs(x)
    out = np.where(
        x <= 1.0,
        (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0,
        np.where(x < 2.0, a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a, 0.0),
    )
    return out


def _linear_kernel(x):
    x = np.abs(x)
    return np.clip(1.0 - x, 0.0, None)


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size, out_size, method="bilinear", antialias=False):
    """(out_size, in_size) float32 interpolation matrix for one axis."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)

    scale = in_size / out_size
    if method == "bilinear":
        kernel, support = _linear_kernel, 1.0
    elif method == "bicubic":
        a = -0.5 if antialias else -0.75
        kernel, support = functools.partial(_cubic_kernel, a=a), 2.0
    else:
        raise ValueError(f"unknown resize method: {method}")

    # Antialias widens the kernel by the downscale factor (no-op upscaling).
    kscale = max(scale, 1.0) if antialias else 1.0

    weights = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale - 0.5
        if antialias:
            lo = int(np.floor(center - support * kscale + 1.0))
            hi = int(np.ceil(center + support * kscale))
            taps = np.arange(lo, hi + 1)
            w = kernel((taps - center) / kscale)
            keep = (taps >= 0) & (taps < in_size)
            taps, w = taps[keep], w[keep]
            weights[o, taps] = w / w.sum()
        else:
            base = int(np.floor(center))
            taps = np.arange(base - int(support) + 1, base + int(support) + 1)
            w = kernel(taps - center)
            # Border replicate: clamp the tap index, accumulate the weight.
            for t, wt in zip(np.clip(taps, 0, in_size - 1), w):
                weights[o, t] += wt
    return weights.astype(np.float32)


def resize_output_size(in_hw, size):
    """torchvision ``Resize`` geometry: int = shorter side, tuple = exact."""
    if isinstance(size, (tuple, list)):
        return tuple(size)
    h, w = in_hw
    if h <= w:
        return size, max(1, int(round(w * size / h)))
    return max(1, int(round(h * size / w))), size


# -----------------------------------------------------------------------------
# Application
# -----------------------------------------------------------------------------


def resize(x, out_hw, method="bilinear", antialias=False, crop=None):
    """Resize NHWC float images via two matmuls.

    ``crop``: optional center-crop size folded INTO the resize — a
    center crop after a resize selects rows of the interpolation
    matrices, so dropping those rows up front is exact and skips the
    cropped-away work."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    wh = resize_matrix(h, oh, method, antialias)
    ww = resize_matrix(w, ow, method, antialias)
    if crop is not None:
        if oh < crop or ow < crop:
            raise ValueError(f"crop {crop} larger than resize {out_hw}")
        top, left = (oh - crop) // 2, (ow - crop) // 2
        wh = wh[top:top + crop]
        ww = ww[left:left + crop]
    wh = torch.as_tensor(wh, dtype=x.dtype, device=x.device)
    ww = torch.as_tensor(ww, dtype=x.dtype, device=x.device)
    x = torch.matmul(wh, x.reshape(n, h, w * c)).reshape(n, -1, w, c)
    return torch.matmul(ww, x)


def center_crop(x, size):
    """Center crop NHWC to (size, size); pads first if too small."""
    n, h, w, c = x.shape
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        x = torch.nn.functional.pad(
            x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        n, h, w, c = x.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return x[:, top:top + size, left:left + size, :]


def quantize_uint8(x):
    """torchvision's float->uint8 cast after resizing a uint8 tensor."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


# -----------------------------------------------------------------------------
# Preprocess pipelines (the reference's per-encoder transform stacks)
# -----------------------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CAFFE_BGR_MEAN = (103.530, 116.280, 123.675)


class Preprocess:
    """A preprocessing pipeline: uint8 NHWC frames -> normalized float NHWC."""

    def __init__(self, resize_size, crop_size, method="bilinear",
                 antialias=False, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 scale_to_unit=True, bgr=False, quantize=True):
        self.resize_size = resize_size
        self.crop_size = crop_size
        self.method = method
        self.antialias = antialias
        self.mean = mean
        self.std = std
        self.scale_to_unit = scale_to_unit
        self.bgr = bgr
        self.quantize = quantize

    def __call__(self, frames, out_dtype=torch.float32):
        """frames: (N, H, W, 3) uint8 tensor (or float already in
        [0, 255]), on the device the work runs on."""
        was_uint8 = frames.dtype == torch.uint8
        # bf16 end to end when bf16 is asked for (uint8 values 0..255 are
        # exact in bf16); f32 otherwise.
        work_dtype = torch.bfloat16 if out_dtype == torch.bfloat16 \
            else torch.float32
        x = frames.to(work_dtype)
        if self.bgr:
            # Channel swap on channels (the reference's _rgb_to_bgr indexes
            # the H dim of an NCHW tensor, src/embeddings.py:285-288 — a
            # bug the JAX package deliberately fixes; so does the port).
            x = x.flip(-1)
        out_hw = resize_output_size(tuple(x.shape[1:3]), self.resize_size)
        if out_hw[0] >= self.crop_size and out_hw[1] >= self.crop_size:
            # crop folded into the resize matrices (exact; the uint8
            # quantize is elementwise, so it commutes with the crop)
            x = resize(x, out_hw, self.method, self.antialias,
                       crop=self.crop_size)
            if was_uint8 and self.quantize:
                x = quantize_uint8(x)
        else:
            x = resize(x, out_hw, self.method, self.antialias)
            if was_uint8 and self.quantize:
                x = quantize_uint8(x)
            x = center_crop(x, self.crop_size)
        if self.scale_to_unit:
            x = x / 255.0
        mean = torch.tensor(self.mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(self.std, dtype=x.dtype, device=x.device)
        x = (x - mean) / std
        return x.to(out_dtype)


def default_preprocess():
    """Resize(256) -> CenterCrop(224) -> /255 -> ImageNet normalize
    (reference: src/embeddings.py:80-85)."""
    return Preprocess(256, 224, method="bilinear")


def mae_preprocess():
    """Same but bicubic resize (interpolation=3; src/embeddings.py:81)."""
    return Preprocess(256, 224, method="bicubic")


def clip_preprocess(input_resolution=224):
    """Bicubic+antialias resize to the CLIP input resolution
    (reference: src/embeddings.py:309-314)."""
    return Preprocess(input_resolution, input_resolution, method="bicubic",
                      antialias=True, mean=CLIP_MEAN, std=CLIP_STD)


def maskrcnn_preprocess():
    """BGR, resize 256, crop 224, mean-subtract only, no /255
    (reference: src/embeddings.py:289-294)."""
    return Preprocess(256, 224, method="bilinear", mean=CAFFE_BGR_MEAN,
                      std=(1.0, 1.0, 1.0), scale_to_unit=False, bgr=True,
                      quantize=False)
