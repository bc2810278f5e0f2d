"""The MAE ViT encoder (arXiv:2111.06377, timm's ViT blocks) at mask
ratio 0, float32: patch embedding, CLS token and position embedding,
pre-LN blocks of softmax attention and a GELU MLP (exact erf, as
``nn.GELU``), the final LayerNorm; the CLS row is the embedding."""

import math

import torch
import torch.nn.functional as F


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], eps)


def _linear(x, w, prefix):
    return F.linear(x, w[f"{prefix}.weight"], w[f"{prefix}.bias"])


def _block(x, w, prefix, heads, eps):
    n, l, d = x.shape
    y = _ln(x, w, f"{prefix}.norm1", eps)
    qkv = _linear(y, w, f"{prefix}.attn.qkv").view(n, l, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # (N, H, L, hd)
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads),
                        dim=-1)
    y = (att @ v).transpose(1, 2).reshape(n, l, d)
    x = x + _linear(y, w, f"{prefix}.attn.proj")
    y = _ln(x, w, f"{prefix}.norm2", eps)
    y = _linear(F.gelu(_linear(y, w, f"{prefix}.mlp.fc1")), w,
                f"{prefix}.mlp.fc2")
    return x + y


def forward(x, w, enc):
    """x: (N, 3, 224, 224) normalized -> (N, embed_dim)."""
    eps = enc["ln_eps"]
    y = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                 stride=enc["patch"])
    y = y.flatten(2).transpose(1, 2) + w["pos_embed"][:, 1:]
    cls = (w["cls_token"] + w["pos_embed"][:, :1]).expand(y.shape[0], -1, -1)
    y = torch.cat([cls, y], dim=1)
    for i in range(enc["depth"]):
        y = _block(y, w, f"blocks.{i}", enc["num_heads"], eps)
    return _ln(y, w, "norm", eps)[:, 0]
