"""Port fused-bottleneck blocks vs. the JAX package's Pallas kernels in
interpret mode (CPU, f32).  The Hopper kernels themselves are held
against these plain versions in tests/test_torch_cuda_kernels.py and
chip_smoke.py, on the card."""

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


def test_main_path_shapes_get_a_tile_that_fits():
    # (ho, stride, cin, P, cout, downsample) of ResNet-50's 8 block shapes
    shapes = [(56, 1, 64, 64, 256, True), (56, 1, 256, 64, 256, False),
              (28, 2, 256, 128, 512, True), (28, 1, 512, 128, 512, False),
              (14, 2, 512, 256, 1024, True), (14, 1, 1024, 256, 1024, False),
              (7, 2, 1024, 512, 2048, True), (7, 1, 2048, 512, 2048, False)]
    bf16_tiles = []
    for ho, s, cin, p, cout, ds in shapes:
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
    assert bf16_tiles == [8, 14, 7, 7, 7, 7, 4, 7]
