"""Port fused-bottleneck blocks vs. the JAX package's Pallas kernels in
interpret mode (CPU, f32).  The Hopper kernels themselves are held
against these plain versions in tests/test_torch_cuda_kernels.py, on the
card."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pvr_habitat_tpu.models import resnet as jresnet
from pvr_habitat_tpu.ops.fold_bn import fold_resnet_bn as jfold
from pvr_habitat_tpu.ops.pallas import fused_bottleneck as jfb
from pvr_habitat_tpu_torch.models import convert
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as tfb

TOL = 1e-4  # the JAX package's own fused-block tolerance (f32)


def _block_params(rng, cin, planes, stride, prefix="layer.0"):
    """Folded params of one bottleneck block with non-trivial biases, as
    (jax dict, port dict)."""
    params = {}
    jresnet._init_bottleneck(params, rng, prefix, cin, planes, stride)
    for key in list(params):
        if key.endswith(".bias") and "downsample" not in key:
            params[key] = rng.randn(*np.shape(params[key])).astype(np.float32)
    folded = jfold({k: jnp.asarray(v) for k, v in params.items()})
    port = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in folded.items()}, "cpu")
    return folded, port


@pytest.mark.parametrize("stride,cin,planes,h", [
    (1, 64, 32, 16),     # layer1-style with downsample (cin != 4*planes)
    (1, 128, 32, 16),    # identity shortcut
    (2, 128, 64, 16),    # strided with downsample
])
def test_plain_v1_matches_pallas(stride, cin, planes, h):
    rng = np.random.RandomState(0)
    jparams, tparams = _block_params(rng, cin, planes, stride)
    x = rng.randn(2, h, h, cin).astype(np.float32)
    want = jfb.fused_bottleneck(
        jnp.asarray(x), *jfb.block_weights(jparams, "layer.0", jnp.float32),
        stride=stride, interpret=True)
    got = tfb.fused_bottleneck(
        torch.from_numpy(x),
        *tfb.block_weights(tparams, "layer.0", torch.float32), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("cin,planes", [(64, 32), (128, 32)])
def test_plain_v2_matches_pallas(cin, planes):
    rng = np.random.RandomState(5)
    h = w = 12
    jparams, tparams = _block_params(rng, cin, planes, 1)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    want = jfb.fused_bottleneck_flat(
        jfb.to_padded_flat(jnp.asarray(x)), jnp.asarray(jfb.flat_mask(h, w)),
        *jfb.block_weights(jparams, "layer.0", jnp.float32), h=h, w=w,
        interpret=True)
    got = tfb.fused_bottleneck_flat(
        tfb.to_padded_flat(torch.from_numpy(x)),
        torch.from_numpy(tfb.flat_mask(h, w)),
        *tfb.block_weights(tparams, "layer.0", torch.float32), h=h, w=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # border invariant preserved for chaining
    border = got.numpy().reshape(2, h + 2, w + 2, -1)
    assert np.all(border[:, 0] == 0) and np.all(border[:, -1] == 0)
    assert np.all(border[:, :, 0] == 0) and np.all(border[:, :, -1] == 0)
    np.testing.assert_array_equal(
        tfb.from_padded_flat(tfb.to_padded_flat(torch.from_numpy(x)), h,
                             w).numpy(), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_weights_match_jax_after_bridge(dtype):
    rng = np.random.RandomState(6)
    jparams, tparams = _block_params(rng, 64, 32, 2)
    want = jfb.block_weights(jparams, "layer.0", getattr(jnp, dtype))
    got = tfb.block_weights(tparams, "layer.0", getattr(torch, dtype))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.is_contiguous()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


# (ho, stride, cin, P, cout, downsample) of ResNet-50's 8 block shapes
RESNET50_SHAPES = {
    "layer1.0": (56, 1, 64, 64, 256, True),
    "layer1.1": (56, 1, 256, 64, 256, False),
    "layer2.0": (28, 2, 256, 128, 512, True),
    "layer2.1": (28, 1, 512, 128, 512, False),
    "layer3.0": (14, 2, 512, 256, 1024, True),
    "layer3.1": (14, 1, 1024, 256, 1024, False),
    "layer4.0": (7, 2, 1024, 512, 2048, True),
    "layer4.1": (7, 1, 2048, 512, 2048, False),
}
BF16_TILES = [8, 14, 7, 7, 7, 7, 4, 7]
SMS = 132  # H100 SXM


def test_main_path_shapes_get_a_tile_that_fits():
    bf16_tiles = []
    for ho, s, cin, p, cout, ds in RESNET50_SHAPES.values():
        for itemsize in (2, 4):
            t = tfb.pick_tile(ho, s, cin, p, cout, ds, itemsize)
            hs = (t - 1) * s + 3
            assert 1 <= t <= ho
            # y1 and y2 at pitch P + 8, and in bf16 the weight ring
            ring = tfb.RING_BYTES if itemsize == 2 else 0
            smem = (hs * hs + t * t) * (p + 8) * itemsize + ring
            assert smem == tfb.smem_bytes(t, s, p, itemsize) <= tfb.MAX_SMEM
            if itemsize == 2:
                bf16_tiles.append(t)
    assert tfb.RING_BYTES == 2 * 32 * (256 + 8) * 2
    # the ring leaves the bf16 tiles where they were before it
    assert bf16_tiles == BF16_TILES


def _blocks(ho, tile, cluster, n):
    return math.ceil(ho / tile) ** 2 * cluster * n


@pytest.mark.parametrize("n", [1, 4, 32, 256])
@pytest.mark.parametrize("block", list(RESNET50_SHAPES))
def test_pick_launch_at_resnet50_shapes(block, n):
    ho, s, cin, p, cout, ds = RESNET50_SHAPES[block]
    # bf16: pick_tile's tile, one block a tile, at every batch
    tile = tfb.pick_tile(ho, s, cin, p, cout, ds, 2)
    assert tile == BF16_TILES[list(RESNET50_SHAPES).index(block)]
    assert tfb.pick_launch(ho, s, cin, p, cout, ds, 2, n, SMS) == (tile, 1)
    parent = tfb.pick_tile(ho, s, cin, p, cout, ds, 4)
    t, c = tfb.pick_launch(ho, s, cin, p, cout, ds, 4, n, SMS)
    if n >= 32:  # the bulk embedder's batch and up launch as before
        assert (t, c) == (parent, 1)
        return
    assert c in (1, 2, 4, 8)
    assert (p // c) % 4 == 0 and (cout // c) % 4 == 0
    assert (t, c) in tfb.launch_shapes(ho, s, p, cout, 4)
    assert t <= ho and tfb.smem_bytes(t, s, p, 4) <= tfb.MAX_SMEM
    assert _blocks(ho, t, c, n) >= _blocks(ho, parent, 1, n)
    if n == 1 and block in ("layer3.1", "layer4.0", "layer4.1"):
        assert _blocks(ho, t, c, n) >= 32


def test_pick_launch_counts_whole_clusters_the_card_holds():
    """With room for fewer clusters of 8 than 132 SMs suggest, a batch-4
    layer4.0 launch takes no cluster size that needs a second wave."""
    ho, s, cin, p, cout, ds = RESNET50_SHAPES["layer4.0"]
    free = tfb.pick_launch(ho, s, cin, p, cout, ds, 4, 4, SMS)
    assert free == (4, 8)  # 16 clusters of 8: one wave on 132 SMs
    held = tfb.pick_launch(ho, s, cin, p, cout, ds, 4, 4, SMS,
                           lambda c, smem: 15 if c == 8 else SMS // c)
    assert held != free and _blocks(ho, *held, 4) <= SMS // held[1] * held[1]
    # a cluster the card cannot hold at all is never chosen
    none = tfb.pick_launch(ho, s, cin, p, cout, ds, 4, 1, SMS,
                           lambda c, smem: 0 if c > 1 else SMS)
    assert none[1] == 1


def test_launch_shapes_split_only_whole_jobs():
    # f32: Cout = 40 is 10 jobs of 4 channels: whole slices over 1 or 2
    # blocks, not 4 (P = 16 alone would allow 4)
    shapes = tfb.launch_shapes(7, 1, 16, 40, 4)
    assert {c for _, c in shapes} == {1, 2}
    assert all(t <= 7 for t, _ in shapes)
    # bf16: one block a tile
    assert {c for _, c in tfb.launch_shapes(7, 1, 512, 2048, 2)} == {1}
