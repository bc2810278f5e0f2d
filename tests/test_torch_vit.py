"""Port ViT primitives and the MAE encoder vs. the JAX package's
``models/common.py`` and ``models/vit.py`` on the same seeded inputs and
weights (CPU).  The small encoder is the oracle of
tests/torch_ref/vit.py at dim 128, depth 2, 4 heads (head dim 32, which
the kernel takes), at 224 input so L = 197."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from pvr_habitat_tpu.models import common as jcm
from pvr_habitat_tpu.models import convert as jconvert
from pvr_habitat_tpu.models import vit as jvit
from pvr_habitat_tpu_torch.models import common as tcm
from pvr_habitat_tpu_torch.models import convert as tconvert
from pvr_habitat_tpu_torch.models import vit as tvit
from pvr_habitat_tpu_torch.ops.cuda import attention as tattn
from pvr_habitat_tpu_torch.utils import profiling
from tests.torch_ref import vit as oracle_vit

F32_TOL = 1e-6      # primitives: same math, other summation order
MAE_TOL = 1e-4      # the encoder, f32
# bf16 primitives: both round to bf16 at every step the JAX package does,
# but the JAX package also rounds inside GELU's tanh formula, op by op,
# where torch rounds once.  One or two bf16 ulps: 2^-6 relative, and
# absolute near zero.
BF16_TOL = 2.0 ** -6
DEPTH, HEADS, DIM = 2, 4, 128


def _x(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_match_jax(dtype):
    x = _x((4, 9, 96), seed=0, scale=2.0) + 0.5
    rng = np.random.RandomState(1)
    p = {"ln.weight": rng.rand(96).astype(np.float32) + 0.5,
         "ln.bias": rng.randn(96).astype(np.float32)}
    tdt = getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want = jcm.layer_norm(jnp.asarray(x, dtype),
                          {k: jnp.asarray(v) for k, v in p.items()}, "ln")
    got = tcm.layer_norm(torch.from_numpy(x).to(tdt),
                         {k: torch.from_numpy(v) for k, v in p.items()}, "ln")
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=tol, rtol=tol)
    want = jcm.gelu(jnp.asarray(x, dtype))
    got = tcm.gelu(torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("embed_dim,grid", [(768, 14), (1280, 16), (64, 3)])
def test_sincos_pos_embed_equals_jax(embed_dim, grid):
    np.testing.assert_array_equal(
        tvit.sincos_pos_embed_2d(embed_dim, grid, cls_token=True),
        jvit.sincos_pos_embed_2d(embed_dim, grid, cls_token=True))


def test_init_mae_params_equals_jax_key_for_key():
    want = jvit.init_mae_params("mae_base", np.random.RandomState(5))
    got = tvit.init_mae_params("mae_base", np.random.RandomState(5), "cpu")
    assert set(got) == set(want) == tvit.mae_param_names("mae_base")
    got = tconvert.params_to_numpy(got)        # OIHW -> the JAX HWIO
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), key)


def _small_encoder():
    """(jax params, port params) of the oracle encoder at a small width,
    with non-trivial biases and norms."""
    torch.manual_seed(0)
    model = oracle_vit.MAEEncoder(img_size=224, patch=16, dim=DIM,
                                  depth=DEPTH, heads=HEADS).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith(".bias") or "norm" in name:
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return jconvert.torch_state_dict_to_flat(model.state_dict()), state


def _mae(params, x, fused="off"):
    return tvit.mae_apply(params, x, depth=DEPTH, num_heads=HEADS, patch=16,
                          fused=fused)


def test_mae_apply_matches_jax_f32():
    """f32 runs the einsum core on either route (``kernel_applies`` is
    False for f32), so ``off`` covers both; the routing spy below and the
    bf16 test cover ``attention``."""
    jparams, tparams = _small_encoder()
    x = _x((2, 224, 224, 3), seed=2)
    want = np.asarray(jvit.mae_apply(jparams, jnp.asarray(x), depth=DEPTH,
                                     num_heads=HEADS, patch=16))
    got = _mae(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, DIM)
    np.testing.assert_allclose(got, want, atol=MAE_TOL, rtol=MAE_TOL)


def _cosine(a, b):
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                               * np.linalg.norm(b, axis=-1))).min()


@pytest.mark.parametrize("fused", ["off", "attention"])
def test_mae_apply_bf16(fused):
    """bf16: the einsum core against the JAX package's bf16 einsum core,
    and both routes against the f32 encoder at the JAX package's own
    gate (cosine > 0.995, tests/test_vit_clip_maskrcnn.py)."""
    jparams, tparams = _small_encoder()
    x = _x((2, 224, 224, 3), seed=3)
    want32 = np.asarray(jvit.mae_apply(jparams, jnp.asarray(x), depth=DEPTH,
                                       num_heads=HEADS, patch=16))
    want16 = np.asarray(jvit.mae_apply(
        {k: v.astype(jnp.bfloat16) for k, v in jparams.items()},
        jnp.asarray(x, jnp.bfloat16), depth=DEPTH, num_heads=HEADS,
        patch=16)).astype(np.float32)
    got = _mae({k: v.bfloat16() for k, v in tparams.items()},
               torch.from_numpy(x).bfloat16(), fused).float().numpy()
    assert _cosine(got, want32) > 0.995
    if fused == "off":     # the same rounding points as the JAX bf16 core
        assert _cosine(got, want16) > 0.9999


@pytest.mark.parametrize("dtype,tokens,fused,calls", [
    (torch.bfloat16, 197, "attention", DEPTH),   # MAE's L: the kernel
    (torch.bfloat16, 128, "attention", DEPTH),
    (torch.bfloat16, 127, "attention", 0),       # L < 128
    (torch.bfloat16, 50, "attention", 0),        # CLIP ViT-B/32's L
    (torch.float32, 197, "attention", 0),        # f32 takes the einsum core
    (torch.bfloat16, 197, "off", 0),
])
def test_attention_route_reaches_kernel_only_for_bf16_long(
        monkeypatch, dtype, tokens, fused, calls):
    seen = []

    def spy(q, k, v):
        seen.append((q.dtype, tuple(q.shape)))
        return tattn.fused_attention_ref(q, k, v)

    monkeypatch.setattr(tattn, "fused_attention", spy)
    _, tparams = _small_encoder()
    params = {k: v.to(dtype) for k, v in tparams.items()}
    y = torch.from_numpy(_x((1, tokens, DIM), seed=4)).to(dtype)
    for i in range(DEPTH):
        y = tvit.timm_block(y, params, f"blocks.{i}", HEADS, fused=fused)
    assert torch.isfinite(y.float()).all()
    assert seen == [(torch.bfloat16, (1, HEADS, tokens, DIM // HEADS))] * calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jax_attention_switches_change_nothing(monkeypatch, dtype):
    """The port reads none of the JAX package's attention switches: the
    route is the ``fused`` argument alone."""
    _, tparams = _small_encoder()
    params = {k: v.to(dtype) for k, v in tparams.items()}
    x = torch.from_numpy(_x((1, 224, 224, 3), seed=5)).to(dtype)
    base = {r: _mae(params, x, r) for r in tvit.FUSED_ROUTES}
    for var, value in (("PVR_TPU_ATTENTION_CORE", "flash"),
                       ("PVR_TPU_ATTENTION_CORE", "pallas"),
                       ("PVR_TPU_ENABLE_PALLAS_ATTENTION", "1"),
                       ("PVR_TPU_DISABLE_PALLAS_ATTENTION", "1")):
        monkeypatch.setenv(var, value)
        for route, want in base.items():
            torch.testing.assert_close(_mae(params, x, route), want,
                                       atol=0, rtol=0)


def _plain_attention(x, wqkv, bqkv, wo, bo, heads, fused):
    """``multihead_attention`` as the op-by-op sequence the JAX package
    rounds at: (N, L, D) products, ``+ b``, the q-scaling fold off the
    kernel."""
    n, l, d = x.shape
    head, dt = d // heads, x.dtype
    wqkv, bqkv = wqkv.to(dt), bqkv.to(dt)
    use_kernel = fused == "attention" and tattn.kernel_applies(dt, l)
    if not use_kernel:
        scale = torch.tensor(1.0 / math.sqrt(head), dtype=dt)
        wqkv = torch.cat([wqkv[:d] * scale, wqkv[d:]])
        bqkv = torch.cat([bqkv[:d] * scale, bqkv[d:]])
    qkv = (x @ wqkv.T + bqkv).view(n, l, 3, heads, head)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    if use_kernel:
        out = tattn.fused_attention(q, k, v)
    else:
        logits = q @ k.transpose(-1, -2)
        if dt == torch.bfloat16:
            e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            probs = e * (1.0 / e.float().sum(dim=-1, keepdim=True)).to(dt)
        else:
            probs = torch.softmax(logits.float(), dim=-1).to(dt)
        out = probs @ v
    out = out.transpose(1, 2).reshape(n, l, d)
    return out @ wo.to(dt).T + bo.to(dt)


def _plain_block(x, p, prefix, heads, fused):
    y = tcm.layer_norm(x, p, f"{prefix}.norm1")
    x = x + _plain_attention(
        y, p[f"{prefix}.attn.qkv.weight"], p[f"{prefix}.attn.qkv.bias"],
        p[f"{prefix}.attn.proj.weight"], p[f"{prefix}.attn.proj.bias"],
        heads, fused)
    y = tcm.layer_norm(x, p, f"{prefix}.norm2")
    n, l, _ = y.shape
    y = tcm.gelu(tcm.linear(y.reshape(n * l, -1), p, f"{prefix}.mlp.fc1"))
    return x + tcm.linear(y, p, f"{prefix}.mlp.fc2").reshape(n, l, -1)


@pytest.mark.parametrize("fused", ["off", "attention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_is_the_plain_sequence_on_the_cpu(dtype, fused):
    """Off the card every product of a block is the product, ``+ b`` and
    ``common.gelu`` op by op: bit for bit the JAX package's rounding
    points, on either route (the bf16 ``attention`` route takes the
    kernel's plain version here)."""
    _, tparams = _small_encoder()
    params = {k: v.to(dtype) for k, v in tparams.items()}
    x = torch.from_numpy(_x((2, 197, DIM), seed=6)).to(dtype)
    with torch.no_grad():
        got = tvit.timm_block(x, params, "blocks.0", HEADS, fused=fused)
        want = _plain_block(x, params, "blocks.0", HEADS, fused)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_is_the_plain_sequence_on_the_cpu(dtype):
    """``multihead_attention`` as CLIP ViT-B/32 calls it: f32 weights, the
    einsum core at L = 50."""
    _, tparams = _small_encoder()
    x = torch.from_numpy(_x((3, 50, DIM), seed=7)).to(dtype)
    args = [tparams[f"blocks.1.attn.{k}"] for k in (
        "qkv.weight", "qkv.bias", "proj.weight", "proj.bias")]
    with torch.no_grad():
        got = tvit.multihead_attention(x, *args, HEADS)
        want = _plain_attention(x, *args, HEADS, "off")
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_products_open_plain_linear_spans_on_the_cpu(dtype):
    """Each of a block's four products opens a ``vit.linear`` span inside
    its half, qkv and the projection in ``vit.attn``, fc1 and fc2 in
    ``vit.mlp``; off the card its ``epilogue`` reads ``plain``."""
    _, tparams = _small_encoder()
    params = {k: v.to(dtype) for k, v in tparams.items()}
    x = torch.from_numpy(_x((1, 197, DIM), seed=8)).to(dtype)
    first = max((s.id for s in profiling.spans()), default=-1) + 1
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        for i in range(DEPTH):
            x = tvit.timm_block(x, params, f"blocks.{i}", HEADS,
                                fused="attention")
    recorded = profiling.spans(first)
    by_id = {s.id: s for s in recorded}
    products = [s for s in recorded if s.name == "vit.linear"]
    assert [by_id[s.parent].name for s in products] == (
        ["vit.attn"] * 2 + ["vit.mlp"] * 2) * DEPTH
    assert [s.attrs for s in products] == [{"epilogue": "plain"}] * (
        4 * DEPTH)
