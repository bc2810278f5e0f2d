"""Port primitives and weight bridge vs. the JAX package's
``models/common.py`` and ``models/convert.py`` (f32, CPU)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pvr_habitat_tpu.models import common as jcm
from pvr_habitat_tpu_torch.models import common as tcm
from pvr_habitat_tpu_torch.models import convert as tconvert

ATOL = 1e-5  # f32 primitives: same math, other summation order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("stride,padding,k,with_bias", [
    (1, 0, 1, False), (2, 1, 3, True), (2, 3, 7, False)])
def test_conv2d_matches_jax(stride, padding, k, with_bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 13, 11, 8).astype(np.float32)
    w_hwio = rng.randn(k, k, 8, 16).astype(np.float32) * 0.1
    b = rng.randn(16).astype(np.float32) if with_bias else None
    want = jcm.conv2d(jnp.asarray(x), jnp.asarray(w_hwio), stride, padding,
                      bias=None if b is None else jnp.asarray(b))
    got = tcm.conv2d(_t(x), _t(np.transpose(w_hwio, (3, 2, 0, 1))), stride,
                     padding, bias=None if b is None else _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_jax(train):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 5, 6).astype(np.float32)
    p = {"bn.weight": rng.rand(6).astype(np.float32) + 0.5,
         "bn.bias": rng.randn(6).astype(np.float32),
         "bn.running_mean": rng.randn(6).astype(np.float32),
         "bn.running_var": rng.rand(6).astype(np.float32) + 0.5}
    want = jcm.batch_norm(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, "bn",
                          train=train)
    got = tcm.batch_norm(_t(x), {k: _t(v) for k, v in p.items()}, "bn",
                         train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_linear_and_max_pool_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7).astype(np.float32)
    p = {"fc.weight": rng.randn(4, 7).astype(np.float32),
         "fc.bias": rng.randn(4).astype(np.float32)}
    want = jcm.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                      "fc")
    got = tcm.linear(_t(x), {k: _t(v) for k, v in p.items()}, "fc")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    # all-negative inputs: the -inf padding must never win
    img = -np.abs(rng.randn(2, 9, 9, 3)).astype(np.float32) - 1.0
    want = jcm.max_pool(jnp.asarray(img))
    got = tcm.max_pool(_t(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_initializers_draw_the_jax_stream():
    for fn, args in ((tcm.kaiming_normal_conv, ((16, 8, 3, 3),)),
                     (tcm.orthogonal_conv, ((32, 3, 3, 3), math.sqrt(2.0))),
                     (tcm.orthogonal, ((5, 9),)),
                     (tcm.uniform_fan_in, ((7,), 27))):
        got = fn(np.random.RandomState(3), *args)
        want = getattr(jcm, fn.__name__)(np.random.RandomState(3), *args)
        if got.ndim == 4:
            got = np.transpose(got, (2, 3, 1, 0))  # port OIHW -> JAX HWIO
        np.testing.assert_array_equal(got, want)


def test_params_bridge_round_trips_exactly():
    rng = np.random.RandomState(4)
    flat = {"conv.weight": rng.randn(3, 3, 4, 8).astype(np.float32),
            "bn.bias": rng.randn(8).astype(np.float32),
            "fc.weight": rng.randn(2, 8).astype(np.float32)}
    params = tconvert.params_from_numpy(flat, "cpu")
    assert params["conv.weight"].shape == (8, 4, 3, 3)  # HWIO -> OIHW
    np.testing.assert_array_equal(params["conv.weight"].numpy(),
                                  np.transpose(flat["conv.weight"],
                                               (3, 2, 0, 1)))
    back = tconvert.params_to_numpy(params)
    assert set(back) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
