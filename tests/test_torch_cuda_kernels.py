"""The Hopper kernels (fused bottleneck, fused attention, LayerNorm) vs.
their plain PyTorch versions, on the card: at the shapes the port runs them
at and at the edges of each kernel's tiling; and the ViT block's products
in the GEMM's cuBLASLt epilogue against the plain sequence they replace.
``chip_smoke.py`` runs this file as its kernel phase.  Imports no JAX, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.models import resnet, vit
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.ops.cuda import attention as fa
from pvr_habitat_tpu_torch.ops.cuda import build
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
from pvr_habitat_tpu_torch.ops.cuda import layer_norm as ln
from pvr_habitat_tpu_torch.ops.fold_bn import fold_resnet_bn

# f32 with TF32 off: only the summation order differs.  bf16: y1 and y2
# are rounded at the same points, but a sum that lands at a rounding
# boundary may round the other way in one of the two.
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _block(rng, cin, planes, stride, dtype):
    params = {}
    resnet._init_bottleneck(params, rng, "b", cin, planes, stride)
    for key in list(params):
        if key.endswith(".bias") and "downsample" not in key:
            params[key] = rng.randn(*np.shape(params[key])).astype(np.float32)
    params = fold_resnet_bn({k: torch.from_numpy(v).cuda()
                             for k, v in params.items()})
    return fb.block_weights(params, "b", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,cin,planes,h", [
    (1, 64, 32, 16), (1, 128, 32, 16),
    # bf16: tile 8 at stride 2 is a 17 x 17 halo, 289 rows, so stage 1
    # walks two m-blocks of 256 and stages W1 once for each
    (2, 128, 64, 16),
    # bf16: P = 16, fewer channels than any block tile is wide
    (1, 64, 16, 7),
    # a projection whose Cin = 48 is no multiple of the 32-row weight chunk
    (1, 48, 16, 8),
    # layer4.1's widths, 2048 -> 512 -> 2048 on 7 x 7: in bf16, 32 x 256
    # block tiles in stages 2 and 3
    (1, 2048, 512, 7)])
def test_kernels_match_plain_versions(dtype, stride, cin, planes, h):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(7)
    w = _block(rng, cin, planes, stride, dtype)
    x = torch.from_numpy(rng.randn(2, h, h, cin).astype(np.float32))
    x = x.to("cuda", dtype)
    before = dict(fb.launches)
    got = fb.fused_bottleneck(x, *w, stride=stride).float()
    want = fb.fused_bottleneck_ref(x, *w, stride=stride).float()
    torch.cuda.synchronize()
    assert fb.launches["fused_bottleneck"] == before["fused_bottleneck"] + 1
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    if stride == 1:
        mask = torch.from_numpy(fb.flat_mask(h, h)).cuda()
        xf = fb.to_padded_flat(x)
        got = fb.fused_bottleneck_flat(xf, mask, *w, h=h, w=h).float()
        want = fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h, w=h).float()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_kernels_match_plain_versions_at_a_ragged_cout(stride):
    """Cout = 40: the last 8-wide n-tile of stage 3 is half of a 16-wide
    ldmatrix pair.  ``_block`` always gives Cout = 4 P, so the weights
    are drawn here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.RandomState(9)
    cin, p, cout, h = 64, 16, 40, 8

    def draw(*shape, dtype=torch.bfloat16):
        fan_in = np.prod(shape[:-1])
        w = rng.randn(*shape).astype(np.float32) / np.sqrt(fan_in)
        return torch.from_numpy(w).to("cuda", dtype).contiguous()

    w = (draw(cin, p), draw(p, dtype=torch.float32), draw(9, p, p),
         draw(p, dtype=torch.float32), draw(p, cout),
         draw(cout, dtype=torch.float32), draw(cin, cout),
         draw(cout, dtype=torch.float32))
    x = torch.from_numpy(rng.randn(2, h, h, cin).astype(np.float32))
    x = x.to("cuda", torch.bfloat16)
    got = fb.fused_bottleneck(x, *w, stride=stride).float()
    want = fb.fused_bottleneck_ref(x, *w, stride=stride).float()
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    if stride == 1:
        mask = torch.from_numpy(fb.flat_mask(h, h)).cuda()
        xf = fb.to_padded_flat(x)
        got = fb.fused_bottleneck_flat(xf, mask, *w, h=h, w=h).float()
        want = fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h, w=h).float()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# ResNet-50 at 224 input, one block of each shape: (H in, stride, Cin,
# planes); "layerS.1" stands for every block of stage S after its first.
RESNET50_BLOCKS = {"layer1.0": (56, 1, 64, 64), "layer1.1": (56, 1, 256, 64),
                   "layer2.0": (56, 2, 256, 128),
                   "layer2.1": (28, 1, 512, 128),
                   "layer3.0": (28, 2, 512, 256),
                   "layer3.1": (14, 1, 1024, 256),
                   "layer4.0": (14, 2, 1024, 512),
                   "layer4.1": (7, 1, 2048, 512)}


@pytest.fixture(scope="module")
def resnet50_params():
    """The service's ResNet-50 weights: the seeded init, BN folded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return EmbeddingNet("resnet50", pretrained=False, device="cuda",
                        fused="off").params


def _row_cosine(got, want):
    """The smallest cosine between a row of ``got`` and its row of
    ``want``, one row a leading index."""
    g, w = (t.float().reshape(t.shape[0], -1) for t in (got, want))
    return float(torch.nn.functional.cosine_similarity(g, w, dim=1).min())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [
    (torch.float32, 1), (torch.float32, 4), (torch.float32, 8),
    (torch.float32, 32), (torch.bfloat16, 256)],
    ids=["f32-1", "f32-4", "f32-8", "f32-32", "bf16-256"])
@pytest.mark.parametrize("block", list(RESNET50_BLOCKS))
def test_kernels_at_resnet50_blocks(resnet50_params, block, dtype, n):
    """Both kernels at every ResNet-50 block shape, with the service's
    weights, against their plain versions: f32 at the batches the port
    gives the f32 engine (1 and 4 eval envs, 8, the bulk embedder's 32)
    within 1e-4 (TF32 off), bf16 at the bulk batch of 256 by each image's
    cosine > 0.999; v2 at the stride-1 blocks, its border zero."""
    torch.backends.cudnn.allow_tf32 = False
    h, stride, cin, planes = RESNET50_BLOCKS[block]
    w = fb.block_weights(resnet50_params, block, dtype)
    gen = torch.Generator(device="cuda").manual_seed(h + cin)
    x = torch.randn(n, h, h, cin, device="cuda", generator=gen).relu_()
    x = x.to(dtype)
    runs = [(fb.fused_bottleneck(x, *w, stride=stride),
             fb.fused_bottleneck_ref(x, *w, stride=stride))]
    if stride == 1:
        mask = torch.from_numpy(fb.flat_mask(h, h)).cuda()
        xf = fb.to_padded_flat(x)
        runs.append((fb.fused_bottleneck_flat(xf, mask, *w, h=h, w=h),
                     fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h, w=h)))
    torch.cuda.synchronize()
    for got, want in runs:
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            assert _row_cosine(got, want) > 0.999
    if stride == 1:
        border = runs[1][0].reshape(n, h + 2, h + 2, 4 * planes)
        for edge in (border[:, 0], border[:, -1], border[:, :, 0],
                     border[:, :, -1]):
            assert not edge.any()


# The f32 engine at the eval batches: ResNet-50's widths where one block a
# tile left the card idle.
F32_EVAL_BLOCKS = {k: RESNET50_BLOCKS[k]
                   for k in ("layer3.1", "layer4.0", "layer4.1")}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("block", list(F32_EVAL_BLOCKS))
def test_f32_launch_shapes_give_the_same_bits(block, n):
    """Every (tile, cluster) that ``pick_launch`` may choose gives the
    output of one block a tile at ``pick_tile``'s tile bit for bit (each
    element is one thread's FMA chain in the same order whichever block
    computes it), and that output is within 1e-4 of the plain version;
    on v1, and on v2 with its zero border at stride 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    h, stride, cin, planes = F32_EVAL_BLOCKS[block]
    rng = np.random.RandomState(17)
    w = _block(rng, cin, planes, stride, torch.float32)
    x = torch.from_numpy(rng.randn(n, h, h, cin).astype(np.float32))
    x = x.cuda().relu_()
    ho, p, cout = h // stride, planes, 4 * planes
    parent = (fb.pick_tile(ho, stride, cin, p, cout, w[6] is not None, 4), 1)
    shapes = fb.launch_shapes(ho, stride, p, cout, 4)
    assert parent in shapes and {c for _, c in shapes} == {1, 2, 4, 8}
    chosen = fb.pick_launch(
        ho, stride, cin, p, cout, w[6] is not None, 4, n,
        torch.cuda.get_device_properties(0).multi_processor_count)
    assert chosen in shapes
    lib = build.load("fused_bottleneck")
    runs = [(False, lambda shape: fb._launch(x, *w, stride, None, shape),
             fb.fused_bottleneck_ref(x, *w, stride=stride))]
    if stride == 1:
        mask = torch.from_numpy(fb.flat_mask(h, h)).cuda()
        xf = fb.to_padded_flat(x)
        runs.append((True, lambda shape: fb._launch_flat(
            xf, mask, *w, h, h, None, shape),
            fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h, w=h)))
    for flat, run, want in runs:
        kernel = "fused_bottleneck_flat" if flat else "fused_bottleneck"
        base = run(parent)
        torch.cuda.synchronize()
        torch.testing.assert_close(base, want, atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])
        for shape in shapes:
            # the card holds at least one cluster of every size offered
            assert fb.max_clusters(lib, 0, flat, shape[1], fb.smem_bytes(
                shape[0], stride, p, 4)) >= 1
            got = run(shape)
            torch.cuda.synchronize()
            assert fb.last_launch[kernel][:2] == shape
            torch.testing.assert_close(got, base, atol=0, rtol=0,
                                       msg=f"{kernel} {shape}")
            if flat:
                border = got.reshape(n, h + 2, h + 2, cout)
                for edge in (border[:, 0], border[:, -1], border[:, :, 0],
                             border[:, :, -1]):
                    assert not edge.any()


@pytest.mark.cuda
def test_bf16_refuses_a_cluster():
    """Only the f32 engine splits a tile over a cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.RandomState(19)
    w = _block(rng, 64, 16, 1, torch.bfloat16)
    x = torch.from_numpy(rng.randn(1, 8, 8, 64).astype(np.float32))
    x = x.to("cuda", torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        fb._launch(x, *w, 1, None, (4, 2))
    mask = torch.from_numpy(fb.flat_mask(8, 8)).cuda()
    with pytest.raises(RuntimeError, match="launch failed"):
        fb._launch_flat(fb.to_padded_flat(x), mask, *w, 8, 8, None, (4, 2))


# Attention.  f32: the JAX test's 1e-5; only the summation order differs.
# bf16: both round p to bf16 and the output to bf16 at the same points, so
# a sum that lands on a rounding boundary moves one bf16 ulp: at most 2^-7
# of the value (rtol), 3.9e-3 below 1 (atol).  (atol, rtol) per dtype.  The
# per-row relative norm error is then at most 2^-7 too; a whole row scaled
# by a few percent (a lost mask, a wrong row sum) fails ATTN_BF16_ROW_REL,
# and the row's cosine must stay above 0.999.
ATTN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 2.0 ** -7)}
ATTN_BF16_ROW_REL = 1e-2


def _assert_attention_matches(got, want, shape, dtype):
    assert got.shape == shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if dtype == torch.bfloat16:
        g = got.float().reshape(-1, shape[-1])
        w = want.float().reshape(-1, shape[-1])
        rel = (g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)
        assert float(rel.max()) <= ATTN_BF16_ROW_REL
        assert _row_cosine(g, w) > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 4, 17, 16),       # the JAX test's ragged shape
    (4, 12, 197, 64),     # mae_base / mae_large heads
    (4, 16, 197, 64),
    (2, 16, 257, 80),     # mae_huge
])
def test_fused_attention_matches_plain_version(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to("cuda", dtype) for _ in range(3))
    before = fa.launches["fused_attention"]
    got = fa.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches["fused_attention"] == before + 1
    _assert_attention_matches(got, fa.fused_attention_ref(q, k, v), shape,
                              dtype)


# The MAE encoders' attention cores: (heads, L, head dim)
MAE_HEADS = {"mae_base": (12, 197, 64), "mae_large": (16, 197, 64),
             "mae_huge": (16, 257, 80)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.float32, 8),
                                     (torch.bfloat16, 256)],
                         ids=["f32-8", "bf16-256"])
@pytest.mark.parametrize("config", list(MAE_HEADS))
def test_fused_attention_at_the_mae_shapes(config, dtype, n):
    """At each MAE's head shape, on (N, H, L, D) views of one
    (N, L, 3, H, D) qkv product, the layout ``models/vit.py`` passes:
    f32 at batch 8, bf16 at the bulk batch of 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    h, l, d = MAE_HEADS[config]
    gen = torch.Generator(device="cuda").manual_seed(n + h + l + d)
    qkv = torch.randn(n, l, 3, h, d, device="cuda", generator=gen).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    got = fa.fused_attention(q, k, v)
    torch.cuda.synchronize()
    _assert_attention_matches(got, fa.fused_attention_ref(q, k, v),
                              (n, h, l, d), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 4, 128, 64),      # 8 key tiles: the smallest register-held row, full
    (2, 4, 208, 64),      # 13 tiles, full: the row mae_base's L = 197 takes
    (2, 4, 256, 64),      # 16 tiles in the 17-tile row
    (2, 4, 272, 80),      # 17 tiles: the longest register-held row
    (2, 4, 272, 128),     # ... at the widest head
    (2, 4, 600, 64),      # past 17 tiles: two passes over the keys
    (2, 2, 1000, 16),     # two passes, ragged
])
def test_fused_attention_bf16_tile_edges(shape):
    """The bf16 engine at the edges of its tiling, against the plain
    version at the bf16 tolerance above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to("cuda", torch.bfloat16) for _ in range(3))
    got = fa.fused_attention(q, k, v)
    torch.cuda.synchronize()
    _assert_attention_matches(got, fa.fused_attention_ref(q, k, v), shape,
                              torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 40, 144])
def test_fused_attention_rejects_head_dims(d):
    """D must be a multiple of 16 up to 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q = torch.zeros(1, 2, 32, d, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.fused_attention(q, q, q)


@pytest.mark.cuda
def test_fused_attention_reads_strided_qkv_views():
    """The ViT call site passes (N, L, H, D)-ordered views of one qkv
    product; the kernel reads them in place and matches the copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    n, l, h, d = 3, 197, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(n, l, 3, h, d, device="cuda", generator=gen,
                      dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    got = fa.fused_attention(q, k, v)
    want = fa.fused_attention(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # the output's memory is (N, L, H, D): the head merge is a view
    assert got.transpose(1, 2).is_contiguous()


# LayerNorm.  bf16: the kernel rounds where the plain version rounds, and
# only its f32 sums run in another order, so a row may differ only where
# its mean or variance lies within a few f32 ulps of a bf16 rounding
# boundary: rows whose exact mean and variance lie further than
# LN_MARGIN (relative) from one must be bit for bit the same, and at least
# LN_SAME_ROWS of all rows.  f32: the order of the sums alone moves the
# mean by an ulp or so, which the normalisation scales by |mean| / std
# (at most about 4 here): each row's worst error over its largest value.
LN_SAME_ROWS = 0.999
LN_MARGIN = 1e-5
LN_F32_TOL = 1e-6


def _ln_inputs(shape, dtype, seed, wdtype=torch.float32):
    """Rows (z + m) * s with an offset m ~ N(0, 1) and a scale
    s = exp(N(0, 1)) of their own; the affine as the benchmark draws it,
    1 + N(0, 0.05) and N(0, 0.05)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen)

    d = shape[-1]
    rows = (*shape[:-1], 1)
    x = (randn(*shape) + randn(*rows)) * randn(*rows).exp()
    return (x.to(dtype), (1 + 0.05 * randn(d)).to(wdtype),
            (0.05 * randn(d)).to(wdtype))


def _near_a_bf16_boundary(v):
    """Where the bf16 rounding of ``v`` (f64) changes within LN_MARGIN."""
    r = v.to(torch.bfloat16)
    return ((v * (1 + LN_MARGIN)).to(torch.bfloat16) != r) | (
        (v * (1 - LN_MARGIN)).to(torch.bfloat16) != r)


def _assert_ln_matches(x, got, want):
    d = x.shape[-1]
    assert got.shape == x.shape and got.dtype == x.dtype
    assert bool(torch.isfinite(got).all())
    if x.dtype == torch.float32:
        err = (got - want).abs().amax(-1) / want.abs().amax(-1)
        assert float(err.max()) <= LN_F32_TOL
        return
    differs = (got.reshape(-1, d) != want.reshape(-1, d)).any(1)
    assert float(differs.float().mean()) <= 1 - LN_SAME_ROWS
    rows = x.reshape(-1, d).double()
    near = (_near_a_bf16_boundary(rows.mean(1))
            | _near_a_bf16_boundary(rows.var(1, unbiased=False)))
    assert not bool((differs & ~near).any()), (
        f"{int((differs & ~near).sum())} rows differ away from a rounding "
        f"boundary")


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [768, 1024, 1280])
def test_layer_norm_matches_plain_version(d, dtype, eps):
    """4,121 rows: not a multiple of the rows a block takes at a time, and
    more than the resident warps, so a warp walks several rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, w, b = _ln_inputs((13, 317, d), dtype, seed=d)
    before = ln.launches["layer_norm"]
    got = ln.layer_norm(x, w, b, eps)
    torch.cuda.synchronize()
    assert ln.launches["layer_norm"] == before + 1
    _assert_ln_matches(x, got, ln.layer_norm_ref(x, w, b, eps))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_reads_the_strided_cls_rows(dtype):
    """CLIP's ``ln_post`` on ``y[:, 0, :]``: rows L * D apart, read in
    place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, w, b = _ln_inputs((37, 50, 768), dtype, seed=5)
    cls = x[:, 0, :]
    assert ln.kernel_rows(cls, w, b).data_ptr() == cls.data_ptr()
    got = ln.layer_norm(cls, w, b, 1e-5)
    torch.cuda.synchronize()
    _assert_ln_matches(cls, got, ln.layer_norm_ref(cls, w, b, 1e-5))
    torch.testing.assert_close(got, ln.layer_norm(cls.contiguous(), w, b,
                                                  1e-5), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("config,shape,dtype,eps", [
    ("mae_base", (256, 197, 768), torch.bfloat16, 1e-6),
    ("mae_base", (8, 197, 768), torch.float32, 1e-6),
    ("mae_huge", (256, 257, 1280), torch.bfloat16, 1e-6),
    ("mae_huge", (8, 257, 1280), torch.float32, 1e-6),
    # CLIP ViT-B/32's ln_post, on the CLS rows of (N, 50, 768)
    ("clip_vit", (256, 50, 768), torch.bfloat16, 1e-5),
    ("clip_vit", (256, 50, 768), torch.float32, 1e-5)],
    ids=["mae_base-bf16-256", "mae_base-f32-8", "mae_huge-bf16-256",
         "mae_huge-f32-8", "clip_vit-bf16-256", "clip_vit-f32-256"])
def test_layer_norm_at_the_vit_shapes(config, shape, dtype, eps):
    """At the ViT encoders' shapes: the MAEs' at the bulk batch of 256 in
    bf16 and at 8 in f32, and CLIP's strided CLS rows, read in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, w, b = _ln_inputs(shape, dtype, seed=sum(shape))
    if config == "clip_vit":
        x = x[:, 0, :]
        assert ln.kernel_rows(x, w, b).data_ptr() == x.data_ptr()
    got = ln.layer_norm(x, w, b, eps)
    torch.cuda.synchronize()
    _assert_ln_matches(x, got, ln.layer_norm_ref(x, w, b, eps))


@pytest.mark.cuda
def test_layer_norm_takes_an_affine_in_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x, w, b = _ln_inputs((3, 197, 768), torch.bfloat16, seed=9,
                         wdtype=torch.bfloat16)
    got = ln.layer_norm(x, w, b)
    torch.cuda.synchronize()
    _assert_ln_matches(x, got, ln.layer_norm_ref(x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(640, torch.bfloat16),
                                     (96, torch.float32),
                                     (768, torch.float16)])
def test_layer_norm_raises_on_the_card_rather_than_falling_back(d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    x = torch.zeros(4, d, device="cuda", dtype=dtype)
    w = torch.ones(d, device="cuda")
    before = ln.launches["layer_norm"]
    with pytest.raises(ValueError):
        ln.layer_norm(x, w, torch.zeros_like(w))
    assert ln.launches["layer_norm"] == before


# The ViT block's four products in bf16 (``models/vit.py::block_linear``):
# the bias, and fc1's bias + tanh GELU, in the GEMM's epilogue, one
# rounding of the f32 result where the plain sequence rounds the product,
# the sum and the GELU each to bf16.  Against the f32 product of the same
# bf16 operands (+ the f32 bias, + the tanh GELU), the epilogue's worst
# row-relative error is at most the plain sequence's, with EPILOGUE_MARGIN
# to spare.
EPILOGUE_MARGIN = 1.1
# (rows at the bulk batch of 256, width) of each MAE the benchmark runs
VIT_ROWS = {"mae_base": (256 * 197, 768), "mae_huge": (256 * 257, 1280)}
# product: (in, out) in units of the width, GELU
VIT_PRODUCTS = {"qkv": (1, 3, False), "proj": (1, 1, False),
                "fc1": (1, 4, True), "fc2": (4, 1, False)}


def _product_operands(config, product, seed):
    """bf16 rows ~ N(0, 1) (a LayerNorm's output), a weight ~ N(0, 1/in)
    and a bias ~ N(0, 0.25), so the bias moves every output."""
    rows, d = VIT_ROWS[config]
    din, dout, gelu = VIT_PRODUCTS[product]
    din, dout = din * d, dout * d
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen)

    return (randn(rows, din).bfloat16(),
            (randn(dout, din) / din ** 0.5).bfloat16(),
            (0.5 * randn(dout)).bfloat16(), gelu)


def _plain_product(x, w, b, gelu):
    y = x @ w.T + b
    return cm.gelu(y) if gelu else y


def _worst_row_rel(got, want):
    got = got.float()
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("product", list(VIT_PRODUCTS))
@pytest.mark.parametrize("config", list(VIT_ROWS))
def test_vit_product_epilogue_at_the_mae_shapes(monkeypatch, config,
                                                product):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x, w, b, gelu = _product_operands(config, product, seed=len(product))
    got = vit.block_linear(x, w, b, gelu=gelu)
    plain = _plain_product(x, w, b, gelu)
    want = x.float() @ w.float().T + b.float()
    if gelu:
        want = torch.nn.functional.gelu(want, approximate="tanh")
    torch.cuda.synchronize()
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert _worst_row_rel(got, want) <= (
        EPILOGUE_MARGIN * _worst_row_rel(plain, want))


@pytest.mark.cuda
@pytest.mark.parametrize("product", list(VIT_PRODUCTS))
@pytest.mark.parametrize("config", list(VIT_ROWS))
def test_vit_product_is_one_gemm_kernel(config, product):
    """Each product launches one GEMM kernel (its epilogue named in it)
    and no elementwise add or GELU kernel.  Three calls under the
    profiler: three launches, counted where the host makes them, since
    the device's record of a profiler run's first kernels can go missing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from torch.profiler import ProfilerActivity, profile

    x, w, b, gelu = _product_operands(config, product, seed=3)
    vit.block_linear(x, w, b, gelu=gelu)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            vit.block_linear(x, w, b, gelu=gelu)
        torch.cuda.synchronize()
    events = prof.events()
    launches = [e.name for e in events if e.device_type.name == "CPU"
                and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    kernels = {e.name for e in events if e.device_type.name == "CUDA"
               and not e.name.startswith(("Memset", "Memcpy"))}
    assert len(launches) == 3, launches
    assert len(kernels) == 1, kernels
    assert not any("elementwise" in k or "Gelu" in k for k in kernels), (
        kernels)


def _vit_block_params(d, seed):
    """One block's weights as the checkpoint holds them, f32: xavier-like
    products, biases ~ N(0, 0.25), LayerNorm affines 1 + N(0, 0.05) and
    N(0, 0.05)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen)

    p = {}
    for name, (din, dout, _) in VIT_PRODUCTS.items():
        key = f"b.{'attn' if name in ('qkv', 'proj') else 'mlp'}.{name}"
        p[f"{key}.weight"] = randn(dout * d, din * d) / (din * d) ** 0.5
        p[f"{key}.bias"] = 0.5 * randn(dout * d)
    for norm in ("norm1", "norm2"):
        p[f"b.{norm}.weight"] = 1 + 0.05 * randn(d)
        p[f"b.{norm}.bias"] = 0.05 * randn(d)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(VIT_ROWS))
def test_timm_block_epilogue_against_the_plain_path(monkeypatch, config):
    """One bf16 block at the bulk batch on the cells' route, its products
    in the epilogue, against the same block with the plain sequence:
    every row's cosine above 0.999."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, depth, heads, patch = vit.MAE_CONFIGS[config]
    rows, d = VIT_ROWS[config]
    p = _vit_block_params(d, seed=d)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(256, rows // 256, d, device="cuda", generator=gen)
    x = x.bfloat16()
    got = vit.timm_block(x, p, "b", heads, fused="attention")
    monkeypatch.setattr(vit, "block_linear",
                        lambda x, w, b, gelu=False: _plain_product(
                            x, w.to(x.dtype), b.to(x.dtype), gelu))
    want = vit.timm_block(x, p, "b", heads, fused="attention")
    torch.cuda.synchronize()
    assert got.shape == want.shape == x.shape
    assert _row_cosine(got.reshape(-1, d), want.reshape(-1, d)) > 0.999
