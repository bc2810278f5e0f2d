"""Vision Transformers: the MAE encoder family and the transformer
primitives (counterpart of ``pvr_habitat_tpu/models/vit.py``; reference:
src/vision_models/mae.py:74-302, used at mask_ratio=0.0 with the CLS
token as the embedding, src/embeddings.py:377-378).

Weights stay in the torch layout ((out, in) linears, OIHW patch
embedding), so a checkpoint's state dict is the flat dict key for key.

``fused`` picks the attention core: ``off`` is the JAX package's einsum
core, with its bf16 semantics (bf16 logits and exp, f32 normalizer) and
1/sqrt(head) folded into the q projection; ``attention`` sends every
core that meets ``ops/cuda/attention.kernel_applies`` (bf16, L >= 128)
through the Hopper kernel with unscaled q, since the kernel scales
internally, and leaves every other core on ``off``.  The projections
and the MLP are plain products outside any kernel, as in the JAX
package, and stay ``torch.matmul``.

``mae_apply_int8`` is the W8A8 serving path (``ops/quantize.py``): the
patch embedding and every block linear int8, LayerNorm and the attention
core in the input dtype.  Its core takes the same ``fused`` rule with
unscaled q; off the kernel it is the int8 block's own core (q times
1/sqrt(head) rounded to q's dtype, an f32 softmax), not
``multihead_attention``'s.

Spans (``utils/profiling.py``): ``vit.attn`` and ``vit.mlp`` around the
two halves of every ``timm_block``; the int8 block has none.
"""

import math

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.ops import image as im
from pvr_habitat_tpu_torch.ops import quantize as qz
from pvr_habitat_tpu_torch.ops.cuda import attention as attn
from pvr_habitat_tpu_torch.utils.platform import resolve_device
from pvr_habitat_tpu_torch.utils.profiling import span

MAE_CONFIGS = {
    # embed_dim, depth, num_heads, patch
    "mae_base": (768, 12, 12, 16),
    "mae_large": (1024, 24, 16, 16),
    "mae_huge": (1280, 32, 16, 14),
}
FUSED_ROUTES = ("off", "attention")

_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
               "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
               "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
               "mlp.fc2.weight", "mlp.fc2.bias")


# -----------------------------------------------------------------------------
# 2-D sin-cos positional embeddings (reference: mae.py:23-70)
# -----------------------------------------------------------------------------


def sincos_pos_embed_1d(embed_dim, pos):
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_2d(embed_dim, grid_size, cls_token=False):
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first
    emb_h = sincos_pos_embed_1d(embed_dim // 2, grid[0])
    emb_w = sincos_pos_embed_1d(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)


# -----------------------------------------------------------------------------
# Transformer primitives
# -----------------------------------------------------------------------------


def multihead_attention(x, wqkv, bqkv, wo, bo, num_heads, fused="off"):
    """x: (N, L, D).  ``wqkv``/``bqkv`` are the fused (3D, D)/(3D,)
    projection as timm ``attn.qkv`` stores it.  One product computes q,
    k and v; q, k and v are (N, L, H, head) views of it, which the kernel
    reads in place."""
    n, l, d = x.shape
    head = d // num_heads
    dt = x.dtype
    wqkv, bqkv = wqkv.to(dt), bqkv.to(dt)
    use_kernel = fused == "attention" and attn.kernel_applies(dt, l)
    if not use_kernel:
        # the einsum core takes 1/sqrt(head) folded into q's weight and
        # bias, in x's dtype (JAX vit.py:87-92); the kernel scales itself
        scale = torch.tensor(1.0 / math.sqrt(head), dtype=dt)
        wqkv = torch.cat([wqkv[:d] * scale, wqkv[d:]])
        bqkv = torch.cat([bqkv[:d] * scale, bqkv[d:]])
    qkv = (x @ wqkv.T + bqkv).view(n, l, 3, num_heads, head)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (N, H, L, head)
    if use_kernel:
        out = attn.fused_attention(q, k, v)
    else:
        logits = q @ k.transpose(-1, -2)
        if dt == torch.bfloat16:
            # bf16 scores and exp, f32 max-shifted normalizer (JAX
            # vit.py:109-118)
            e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            denom = e.float().sum(dim=-1, keepdim=True)
            probs = e * (1.0 / denom).to(dt)
        else:
            probs = torch.softmax(logits.float(), dim=-1).to(dt)
        out = probs @ v
    out = out.transpose(1, 2).reshape(n, l, d)
    return out @ wo.to(dt).T + bo.to(dt)


def timm_block(x, p, prefix, num_heads, eps=1e-6, gelu=cm.gelu, fused="off"):
    """timm ViT Block: pre-LN attention + MLP with residuals, each half
    (its norm, its products and its residual add) in a span of its own,
    ``vit.attn`` and ``vit.mlp``."""
    with span("vit.attn"):
        y = cm.layer_norm(x, p, f"{prefix}.norm1", eps=eps)
        y = multihead_attention(
            y, p[f"{prefix}.attn.qkv.weight"], p[f"{prefix}.attn.qkv.bias"],
            p[f"{prefix}.attn.proj.weight"], p[f"{prefix}.attn.proj.bias"],
            num_heads, fused=fused)
        x = x + y
    with span("vit.mlp"):
        y = cm.layer_norm(x, p, f"{prefix}.norm2", eps=eps)
        n, l, _ = y.shape
        y = y.reshape(n * l, -1)
        y = gelu(cm.linear(y, p, f"{prefix}.mlp.fc1"))
        y = cm.linear(y, p, f"{prefix}.mlp.fc2")
        return x + y.reshape(n, l, -1)


# -----------------------------------------------------------------------------
# MAE encoder
# -----------------------------------------------------------------------------


def mae_apply(params, x, *, depth, num_heads, patch, train=False,
              fused="off"):
    """x: (N, 224, 224, 3) normalized NHWC -> (N, D) CLS embedding.
    forward_encoder at mask_ratio=0.0 (reference: mae.py:190-224)."""
    del train
    n = x.shape[0]
    # PatchEmbed: conv patch x patch stride patch == unfold + linear.
    y = cm.conv2d(x, params["patch_embed.proj.weight"], stride=patch,
                  padding=0, bias=params["patch_embed.proj.bias"])
    gh, gw, d = y.shape[1], y.shape[2], y.shape[3]
    y = y.reshape(n, gh * gw, d)
    pos = params["pos_embed"].to(y.dtype)
    y = y + pos[:, 1:, :]
    cls = params["cls_token"].to(y.dtype) + pos[:, :1, :]
    y = torch.cat([cls.expand(n, 1, d), y], dim=1)
    for i in range(depth):
        y = timm_block(y, params, f"blocks.{i}", num_heads, fused=fused)
    y = cm.layer_norm(y, params, "norm", eps=1e-6)
    return y[:, 0, :]


def int8_block_core(q, k, v):
    """The int8 block's attention core off the kernel (JAX
    vit.py:188-192), (N, H, L, D) -> (N, H, L, D): q times 1/sqrt(D)
    rounded to q's dtype, logits in q's dtype, an f32 softmax rounded to
    q's dtype."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    logits = (q * scale) @ k.transpose(-1, -2)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return probs @ v


def _timm_block_q(qs, x, p, prefix, num_heads, fused="off"):
    """int8 ViT block: the linears W8A8; LayerNorm, the attention core and
    GELU (op by op, as the JAX package computes it) in x's dtype."""
    n, l, d = x.shape
    head = d // num_heads
    y = cm.layer_norm(x, p, f"{prefix}.norm1", eps=1e-6)
    qkv = qz.linear_q(qs, f"{prefix}.attn.qkv", y.reshape(n * l, d), p)
    qkv = qkv.view(n, l, 3, num_heads, head)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (N, H, L, head)
    if fused == "attention" and attn.kernel_applies(q.dtype, l):
        out = attn.fused_attention(q, k, v)     # unscaled q
    else:
        out = int8_block_core(q, k, v)
    out = out.transpose(1, 2).reshape(n * l, d)
    x = x + qz.linear_q(qs, f"{prefix}.attn.proj", out, p).view(n, l, d)
    y = cm.layer_norm(x, p, f"{prefix}.norm2", eps=1e-6)
    y = cm.gelu_tanh_stepwise(qz.linear_q(qs, f"{prefix}.mlp.fc1",
                                          y.reshape(n * l, d), p))
    y = qz.linear_q(qs, f"{prefix}.mlp.fc2", y, p)
    return x + y.view(n, l, d)


def mae_apply_int8(params_q, x, *, depth, num_heads, patch, scales=None,
                   fused="off"):
    """W8A8 MAE encoder.  ``params_q``: ``quantize_vit_params(params)``;
    ``scales=None`` calibrates on this batch.  Returns (cls, scales)."""
    qs = qz.QuantState(scales)
    n = x.shape[0]
    y = qz.conv_q(qs, "patch_embed.proj", x, params_q, patch, 0,
                  bias=params_q["patch_embed.proj.bias"].float())
    gh, gw, d = y.shape[1], y.shape[2], y.shape[3]
    y = y.reshape(n, gh * gw, d)
    pos = params_q["pos_embed"].to(y.dtype)
    y = y + pos[:, 1:, :]
    cls = params_q["cls_token"].to(y.dtype) + pos[:, :1, :]
    y = torch.cat([cls.expand(n, 1, d), y], dim=1)
    for i in range(depth):
        y = _timm_block_q(qs, y, params_q, f"blocks.{i}", num_heads,
                          fused=fused)
    y = cm.layer_norm(y, params_q, "norm", eps=1e-6)
    return y[:, 0, :], qs.scales


def mae_param_names(name):
    depth = MAE_CONFIGS[name][1]
    return ({"patch_embed.proj.weight", "patch_embed.proj.bias",
             "cls_token", "pos_embed", "norm.weight", "norm.bias"}
            | {f"blocks.{i}.{key}" for i in range(depth)
               for key in _BLOCK_KEYS})


def init_mae_params(name, rng, device=None):
    """Xavier-uniform torch-equivalent init and the fixed sin-cos pos
    embed, drawn in the JAX package's numpy order; the patch embedding
    is OIHW."""
    embed_dim, depth, num_heads, patch = MAE_CONFIGS[name]
    out = {}

    def xavier(shape_out_in):
        fan_out, fan_in = shape_out_in
        a = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-a, a, size=shape_out_in).astype(np.float32)

    out["patch_embed.proj.weight"] = xavier(
        (embed_dim, 3 * patch * patch)).reshape(embed_dim, 3, patch, patch)
    out["patch_embed.proj.bias"] = np.zeros(embed_dim, np.float32)
    out["cls_token"] = (rng.normal(0, 0.02, (1, 1, embed_dim))
                        .astype(np.float32))
    out["pos_embed"] = sincos_pos_embed_2d(
        embed_dim, 224 // patch, cls_token=True)[None]
    ones, zeros = np.ones(embed_dim, np.float32), np.zeros(embed_dim,
                                                           np.float32)
    for i in range(depth):
        pre = f"blocks.{i}"
        out[f"{pre}.norm1.weight"], out[f"{pre}.norm1.bias"] = ones, zeros
        out[f"{pre}.attn.qkv.weight"] = xavier((3 * embed_dim, embed_dim))
        out[f"{pre}.attn.qkv.bias"] = np.zeros(3 * embed_dim, np.float32)
        out[f"{pre}.attn.proj.weight"] = xavier((embed_dim, embed_dim))
        out[f"{pre}.attn.proj.bias"] = zeros
        out[f"{pre}.norm2.weight"], out[f"{pre}.norm2.bias"] = ones, zeros
        out[f"{pre}.mlp.fc1.weight"] = xavier((4 * embed_dim, embed_dim))
        out[f"{pre}.mlp.fc1.bias"] = np.zeros(4 * embed_dim, np.float32)
        out[f"{pre}.mlp.fc2.weight"] = xavier((embed_dim, 4 * embed_dim))
        out[f"{pre}.mlp.fc2.bias"] = zeros
    out["norm.weight"], out["norm.bias"] = ones, zeros
    dev = resolve_device(device)
    return {k: torch.tensor(v, device=dev) for k, v in out.items()}


def mae_params_from_state_dict(name, state_dict, device):
    """The encoder's entries of an MAE checkpoint's state dict (the
    decoder_* keys are ignored, as the reference's strict=False load
    does), with ``pos_embed`` regenerated if the file omits it."""
    embed_dim, _, _, patch = MAE_CONFIGS[name]
    expected = mae_param_names(name)
    params = {k: v.detach().float().to(device)
              for k, v in state_dict.items() if k in expected}
    if "pos_embed" not in params:
        params["pos_embed"] = torch.from_numpy(sincos_pos_embed_2d(
            embed_dim, 224 // patch, cls_token=True)[None]).to(device)
    return params


def build_mae_encoder(name, pretrained=True, checkpoint_dir=None,
                      device=None):
    from pvr_habitat_tpu_torch.models import convert
    from pvr_habitat_tpu_torch.models.registry import (EncoderHandle,
                                                       _load_or_init,
                                                       _name_seed)

    embed_dim, depth, num_heads, patch = MAE_CONFIGS[name]
    dev = resolve_device(device)

    def load(ckpt):
        params = mae_params_from_state_dict(name, ckpt.get("model", ckpt),
                                            dev)
        convert.check_expected(params, mae_param_names(name), context=name)
        return params

    params = _load_or_init(
        name, pretrained, checkpoint_dir, load,
        lambda: init_mae_params(name, np.random.RandomState(_name_seed(name)),
                                dev))

    def apply_fn(p, x, train=False, fused="off"):
        return mae_apply(p, x, depth=depth, num_heads=num_heads,
                         patch=patch, train=train, fused=fused)

    return EncoderHandle(name, im.mae_preprocess(), apply_fn, params,
                         embed_dim, FUSED_ROUTES)
