"""torchvision's eval transform of the PVR encoders on uint8 frames:
Resize(256) -> CenterCrop(224) -> ToTensor -> Normalize.

A uint8 tensor resized by torchvision is rounded back to uint8 (half to
even, as ``torch.round``) before the division by 255.  ``bilinear`` and
``bicubic`` are ``F.interpolate``'s, without antialias (upsampling
64 -> 256 has none to apply), half-pixel centres and a clamped border.
"""

import torch
import torch.nn.functional as F


def preprocess(frames, enc):
    """frames: (N, H, W, 3) uint8 -> (N, 3, crop, crop) float32, NCHW."""
    x = frames.permute(0, 3, 1, 2).float()
    size = enc["resize"]
    h, w = x.shape[-2:]
    out = (size, round(w * size / h)) if h <= w else \
        (round(h * size / w), size)
    x = F.interpolate(x, size=out, mode=enc["interpolation"],
                      align_corners=False)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    crop = enc["input_hw"]
    top, left = (out[0] - crop) // 2, (out[1] - crop) // 2
    x = x[:, :, top:top + crop, left:left + crop] / 255.0
    mean = torch.tensor(enc["mean"], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(enc["std"], device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std
