"""Port preprocess vs. the JAX package's ``ops/image.py`` on the same
uint8 frames (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pvr_habitat_tpu.ops import image as jim
from pvr_habitat_tpu_torch.ops import image as tim

PRESETS = ["default_preprocess", "mae_preprocess", "clip_preprocess",
           "maskrcnn_preprocess"]


def _frames(seed=0, n=2):
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("args", [
    (64, 256, "bilinear", False), (64, 256, "bicubic", False),
    (64, 224, "bicubic", True), (256, 100, "bilinear", True)])
def test_resize_matrix_equals_jax(args):
    np.testing.assert_array_equal(tim.resize_matrix(*args),
                                  jim.resize_matrix(*args))


@pytest.mark.parametrize("preset", PRESETS)
def test_preprocess_matches_jax_f32(preset):
    frames = _frames(1)
    pre_j, pre_t = getattr(jim, preset)(), getattr(tim, preset)()
    want = np.asarray(pre_j(jnp.asarray(frames)))
    got = pre_t(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    diff = np.abs(got - want)
    if pre_t.method == "bilinear":
        # 64 -> 256 bilinear weights are multiples of 1/8: the resize is
        # exact in f32, so the uint8 round-trip agrees bit for bit.
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    # Bicubic weights are not dyadic: the two packages sum the resize in
    # another order, and a sum within one f32 ulp of x.5 rounds to the
    # other side (round-half-to-even).  Everything else agrees at 1e-5;
    # a flip moves one element by one quantum 1/255/std, and at most
    # 1e-5 of the elements flip.
    quantum = np.broadcast_to(1.0 / 255.0 / np.asarray(pre_t.std), diff.shape)
    flips = diff > 1e-5
    assert np.mean(flips) <= 1e-5, np.mean(flips)
    np.testing.assert_allclose(diff[flips], quantum[flips], rtol=1e-3)


@pytest.mark.parametrize("method,antialias,out", [
    ("bilinear", False, 256), ("bicubic", False, 256),
    ("bicubic", True, 224)])
def test_resize_matches_jax_before_rounding(method, antialias, out):
    frames = _frames(2)
    crop = 224 if out > 224 else None
    want = np.asarray(jim.resize(jnp.asarray(frames, jnp.float32),
                                 (out, out), method, antialias, crop=crop))
    got = tim.resize(torch.from_numpy(frames).float(), (out, out), method,
                     antialias, crop=crop).numpy()
    # values up to 255 in f32: a few ulps of reordering
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


def test_preprocess_bf16_mode_matches_jax():
    frames = _frames(3)
    want = np.asarray(jim.default_preprocess()(
        jnp.asarray(frames), out_dtype=jnp.bfloat16).astype(jnp.float32))
    got = tim.default_preprocess()(
        torch.from_numpy(frames), out_dtype=torch.bfloat16).float().numpy()
    # bf16 normalize rounds at other places in the two frameworks: gate
    # each frame's cosine and bound the error by two bf16 ulps of 2.7.
    a, b = got.reshape(2, -1), want.reshape(2, -1)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() > 0.9999, cos
    assert np.abs(a - b).max() <= 2 * 2.0 ** -6


def test_float_input_skips_the_uint8_round_trip():
    frames = _frames(4).astype(np.float32) + 0.25
    want = np.asarray(jim.default_preprocess()(jnp.asarray(frames)))
    got = tim.default_preprocess()(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
