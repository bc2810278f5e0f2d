"""CLIP visual towers (counterpart of ``pvr_habitat_tpu/models/clip.py``;
reference: src/embeddings.py:298-314 loads openai/CLIP 'ViT-B/32' and
'RN50' and embeds via encode_image).

OpenAI checkpoint key names under the ``visual.`` prefix; a checkpoint's
state dict is the flat dict key for key (OIHW convs; ``visual.proj`` is
the (width, output_dim) matrix applied as ``y @ proj``, not a Linear):

- ViT-B/32: patch conv (no bias) -> class embedding + learned
  positional embedding -> ln_pre -> 12 pre-LN resblocks with QuickGELU
  -> ln_post on CLS -> projection to 512.  The attention cores run on
  ``vit.multihead_attention``'s einsum core: at L = 50 no core meets the
  attention kernel's condition (``ops/cuda/attention.kernel_applies``).
- RN50 (ModifiedResNet): 3-conv stem with avgpool, bottlenecks whose
  stride is an avgpool (conv strides are all 1), and an AttentionPool2d
  head (mean token as query, f32 softmax) to 1024.

Both run on ``F.conv2d`` and ``torch.matmul`` only (routes ``("off",)``),
as the JAX package leaves them to XLA.  The int8 RN50 path is not ported
yet (ROADMAP.md queue 1, item 6).
"""

import math

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.models.vit import multihead_attention
from pvr_habitat_tpu_torch.ops import image as im
from pvr_habitat_tpu_torch.utils.platform import resolve_device


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


# -----------------------------------------------------------------------------
# ViT-B/32 tower
# -----------------------------------------------------------------------------

VIT_B32 = dict(width=768, layers=12, heads=12, patch=32,
               input_resolution=224, output_dim=512)


def _clip_resblock(x, p, prefix, num_heads):
    y = cm.layer_norm(x, p, f"{prefix}.ln_1", eps=1e-5)
    y = multihead_attention(
        y, p[f"{prefix}.attn.in_proj_weight"],
        p[f"{prefix}.attn.in_proj_bias"],
        p[f"{prefix}.attn.out_proj.weight"],
        p[f"{prefix}.attn.out_proj.bias"], num_heads)
    x = x + y
    y = cm.layer_norm(x, p, f"{prefix}.ln_2", eps=1e-5)
    n, l, _ = y.shape
    y = y.reshape(n * l, -1)
    y = quick_gelu(cm.linear(y, p, f"{prefix}.mlp.c_fc"))
    y = cm.linear(y, p, f"{prefix}.mlp.c_proj")
    return x + y.reshape(n, l, -1)


def clip_vit_apply(params, x, train=False, cfg=VIT_B32):
    """x: (N, 224, 224, 3) normalized NHWC -> (N, output_dim)."""
    del train
    n = x.shape[0]
    y = cm.conv2d(x, params["visual.conv1.weight"], stride=cfg["patch"],
                  padding=0)
    gh, gw, d = y.shape[1], y.shape[2], y.shape[3]
    y = y.reshape(n, gh * gw, d)
    cls = params["visual.class_embedding"].to(y.dtype)
    y = torch.cat([cls.reshape(1, 1, d).expand(n, 1, d), y], dim=1)
    y = y + params["visual.positional_embedding"].to(y.dtype)
    y = cm.layer_norm(y, params, "visual.ln_pre", eps=1e-5)
    for i in range(cfg["layers"]):
        y = _clip_resblock(y, params, f"visual.transformer.resblocks.{i}",
                           cfg["heads"])
    y = cm.layer_norm(y[:, 0, :], params, "visual.ln_post", eps=1e-5)
    return y @ params["visual.proj"].to(y.dtype)    # (width, output_dim)


def _init_clip_vit_numpy(rng, cfg):
    width, layers, patch = cfg["width"], cfg["layers"], cfg["patch"]
    grid = cfg["input_resolution"] // patch
    scale = width ** -0.5
    out = {}
    out["visual.conv1.weight"] = rng.normal(
        0, scale, (width, 3, patch, patch)).astype(np.float32)
    out["visual.class_embedding"] = (
        scale * rng.normal(0, 1, (width,))).astype(np.float32)
    out["visual.positional_embedding"] = (
        scale * rng.normal(0, 1, (grid * grid + 1, width))).astype(np.float32)
    for ln in ("ln_pre", "ln_post"):
        out[f"visual.{ln}.weight"] = np.ones(width, np.float32)
        out[f"visual.{ln}.bias"] = np.zeros(width, np.float32)
    for i in range(layers):
        pre = f"visual.transformer.resblocks.{i}"
        out[f"{pre}.ln_1.weight"] = np.ones(width, np.float32)
        out[f"{pre}.ln_1.bias"] = np.zeros(width, np.float32)
        out[f"{pre}.ln_2.weight"] = np.ones(width, np.float32)
        out[f"{pre}.ln_2.bias"] = np.zeros(width, np.float32)
        out[f"{pre}.attn.in_proj_weight"] = (
            rng.normal(0, scale, (3 * width, width))).astype(np.float32)
        out[f"{pre}.attn.in_proj_bias"] = np.zeros(3 * width, np.float32)
        out[f"{pre}.attn.out_proj.weight"] = (
            rng.normal(0, scale, (width, width))).astype(np.float32)
        out[f"{pre}.attn.out_proj.bias"] = np.zeros(width, np.float32)
        out[f"{pre}.mlp.c_fc.weight"] = (
            rng.normal(0, scale, (4 * width, width))).astype(np.float32)
        out[f"{pre}.mlp.c_fc.bias"] = np.zeros(4 * width, np.float32)
        out[f"{pre}.mlp.c_proj.weight"] = (
            rng.normal(0, scale, (width, 4 * width))).astype(np.float32)
        out[f"{pre}.mlp.c_proj.bias"] = np.zeros(width, np.float32)
    out["visual.proj"] = (
        scale * rng.normal(0, 1, (width, cfg["output_dim"]))
    ).astype(np.float32)
    return out


def init_clip_vit_params(rng, cfg=VIT_B32, device=None):
    """The JAX package's init draw for draw; the patch conv is OIHW."""
    return _to_device(_init_clip_vit_numpy(rng, cfg), device)


# -----------------------------------------------------------------------------
# ModifiedResNet (RN50) tower
# -----------------------------------------------------------------------------

RN50 = dict(layers=(3, 4, 6, 3), width=64, output_dim=1024, heads=32,
            input_resolution=224)


def _modified_bottleneck(x, p, prefix, stride, train):
    identity = x
    y = cm.conv2d(x, p[f"{prefix}.conv1.weight"], 1, 0)
    y = torch.relu(cm.batch_norm(y, p, f"{prefix}.bn1", train=train))
    y = cm.conv2d(y, p[f"{prefix}.conv2.weight"], 1, 1)
    y = torch.relu(cm.batch_norm(y, p, f"{prefix}.bn2", train=train))
    if stride > 1:
        y = cm.avg_pool(y, stride)
    y = cm.conv2d(y, p[f"{prefix}.conv3.weight"], 1, 0)
    y = cm.batch_norm(y, p, f"{prefix}.bn3", train=train)
    if f"{prefix}.downsample.1.weight" in p:
        # OpenAI downsample: ('-1' avgpool, '0' 1x1 conv, '1' bn)
        identity = cm.avg_pool(identity, stride) if stride > 1 else identity
        identity = cm.conv2d(identity, p[f"{prefix}.downsample.0.weight"],
                             1, 0)
        identity = cm.batch_norm(identity, p, f"{prefix}.downsample.1",
                                 train=train)
    return torch.relu(y + identity)


def _attention_pool(x, p, num_heads):
    """AttentionPool2d: (N, H, W, C) -> (N, output_dim).  The query is the
    mean token; q is scaled before the logits and the softmax runs in f32
    (JAX clip.py:147-174), unlike ``vit.multihead_attention``'s bf16
    score path."""
    n, h, w, c = x.shape
    tokens = x.reshape(n, h * w, c)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + p["visual.attnpool.positional_embedding"].to(
        tokens.dtype)[None]

    def proj(name, t):
        return cm.linear(t, p, f"visual.attnpool.{name}")

    q = proj("q_proj", tokens[:, :1])
    k = proj("k_proj", tokens)
    v = proj("v_proj", tokens)
    head = q.shape[-1] // num_heads
    q = q.reshape(n, 1, num_heads, head).transpose(1, 2)   # (N, H, 1, d)
    k = k.reshape(n, -1, num_heads, head).transpose(1, 2)
    v = v.reshape(n, -1, num_heads, head).transpose(1, 2)
    scale = torch.tensor(1.0 / math.sqrt(head), dtype=q.dtype)
    logits = (q * scale) @ k.transpose(-1, -2)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = (probs @ v).transpose(1, 2).reshape(n, 1, num_heads * head)
    return proj("c_proj", out)[:, 0]


def clip_rn50_apply(params, x, train=False, cfg=RN50):
    """x: (N, 224, 224, 3) normalized NHWC -> (N, output_dim)."""
    y = x
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        y = cm.conv2d(y, params[f"visual.conv{i}.weight"], stride, 1)
        y = torch.relu(cm.batch_norm(y, params, f"visual.bn{i}",
                                     train=train))
    y = cm.avg_pool(y, 2)
    for stage_idx, blocks in enumerate(cfg["layers"]):
        stride = 1 if stage_idx == 0 else 2
        for i in range(blocks):
            y = _modified_bottleneck(
                y, params, f"visual.layer{stage_idx + 1}.{i}",
                stride if i == 0 else 1, train)
    return _attention_pool(y, params, cfg["heads"])


def _init_clip_rn50_numpy(rng, cfg):
    out = {}
    width = cfg["width"]

    def conv(name, o, i, k):
        out[f"{name}.weight"] = cm.kaiming_normal_conv(rng, (o, i, k, k))

    def bn(name, ch):
        out[f"{name}.weight"] = np.ones(ch, np.float32)
        out[f"{name}.bias"] = np.zeros(ch, np.float32)
        out[f"{name}.running_mean"] = np.zeros(ch, np.float32)
        out[f"{name}.running_var"] = np.ones(ch, np.float32)

    conv("visual.conv1", width // 2, 3, 3)
    bn("visual.bn1", width // 2)
    conv("visual.conv2", width // 2, width // 2, 3)
    bn("visual.bn2", width // 2)
    conv("visual.conv3", width, width // 2, 3)
    bn("visual.bn3", width)

    cin = width
    for stage_idx, blocks in enumerate(cfg["layers"]):
        planes = width * (2 ** stage_idx)
        for i in range(blocks):
            pre = f"visual.layer{stage_idx + 1}.{i}"
            conv(f"{pre}.conv1", planes, cin, 1)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2", planes, planes, 3)
            bn(f"{pre}.bn2", planes)
            conv(f"{pre}.conv3", planes * 4, planes, 1)
            bn(f"{pre}.bn3", planes * 4)
            if i == 0 and (stage_idx > 0 or cin != planes * 4):
                conv(f"{pre}.downsample.0", planes * 4, cin, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            cin = planes * 4
    embed_dim = width * 32  # 2048
    spacial = (cfg["input_resolution"] // 32) ** 2
    out["visual.attnpool.positional_embedding"] = (
        rng.normal(0, embed_dim ** -0.5, (spacial + 1, embed_dim))
    ).astype(np.float32)
    for name, o in (("q_proj", embed_dim), ("k_proj", embed_dim),
                    ("v_proj", embed_dim), ("c_proj", cfg["output_dim"])):
        out[f"visual.attnpool.{name}.weight"] = (
            rng.normal(0, embed_dim ** -0.5, (o, embed_dim))
        ).astype(np.float32)
        out[f"visual.attnpool.{name}.bias"] = np.zeros(o, np.float32)
    return out


def init_clip_rn50_params(rng, cfg=RN50, device=None):
    """The JAX package's init draw for draw; convs are OIHW."""
    return _to_device(_init_clip_rn50_numpy(rng, cfg), device)


def _to_device(flat, device):
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in flat.items()}


# -----------------------------------------------------------------------------
# The encoder handle
# -----------------------------------------------------------------------------

_TOWERS = {
    # name: (cfg, numpy init, apply, out_size)
    "clip_vit": (VIT_B32, _init_clip_vit_numpy, clip_vit_apply, 512),
    "clip_rn50": (RN50, _init_clip_rn50_numpy, clip_rn50_apply, 1024),
}


def build_clip_encoder(name, pretrained=True, checkpoint_dir=None,
                       device=None):
    from pvr_habitat_tpu_torch.models import convert
    from pvr_habitat_tpu_torch.models.registry import (EncoderHandle,
                                                       _load_or_init,
                                                       _name_seed)

    if name not in _TOWERS:
        raise NotImplementedError(f"Requested model not available: {name}")
    cfg, init_numpy, apply_fn, out_size = _TOWERS[name]
    dev = resolve_device(device)

    def load(ckpt):
        state_dict = ckpt.get("state_dict", ckpt)
        expected = set(init_numpy(cm.ShapeRNG(), cfg))
        params = {k: v.detach().float().to(dev)
                  for k, v in state_dict.items() if k in expected}
        convert.check_expected(params, expected, context=name)
        return params

    params = _load_or_init(
        name, pretrained, checkpoint_dir, load,
        lambda: _to_device(init_numpy(
            np.random.RandomState(_name_seed(name)), cfg), dev))

    return EncoderHandle(
        name, im.clip_preprocess(cfg["input_resolution"]),
        lambda p, x, train=False: apply_fn(p, x, train=train),
        params, out_size)
