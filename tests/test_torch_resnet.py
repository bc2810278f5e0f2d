"""Port ResNets vs. the JAX package's ``models/resnet.py`` and
``ops/fold_bn.py`` on the same seeded weights (CPU, f32).  The fused
routes run the kernels' plain versions here; the tolerance is the
BASELINE.md parity contract, 1e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pvr_habitat_tpu.models import resnet as jresnet
from pvr_habitat_tpu.ops.fold_bn import fold_resnet_bn as jfold
from pvr_habitat_tpu_torch.models import convert
from pvr_habitat_tpu_torch.models import resnet as tresnet
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as tfb
from pvr_habitat_tpu_torch.ops.fold_bn import fold_resnet_bn as tfold

TOL = 1e-3


def _random_bn(flat, seed):
    """Non-trivial running stats (as tests/test_resnet.py draws them) so
    eval normalization and folding matter."""
    rng = np.random.RandomState(seed)
    out = dict(flat)
    for key, value in flat.items():
        if key.endswith("running_mean"):
            out[key] = (rng.randn(*np.shape(value)) * 0.1).astype(np.float32)
        elif key.endswith("running_var"):
            out[key] = (rng.rand(*np.shape(value)) + 0.5).astype(np.float32)
    return out


def _pair(spec, seed):
    """(jax params, port params) from the same numpy draw."""
    flat = {k: np.asarray(v) for k, v in
            jresnet.init_params(spec, np.random.RandomState(seed)).items()}
    flat = _random_bn(flat, seed + 100)
    return ({k: jnp.asarray(v) for k, v in flat.items()},
            convert.params_from_numpy(flat, "cpu"))


def _x(seed, batch=1):
    return np.random.RandomState(seed).randn(batch, 64, 64, 3).astype(
        np.float32)


@pytest.mark.parametrize("depth,cut", [(50, None), (50, "l3"), (18, None)])
def test_init_params_bridged_equal_jax(depth, cut):
    spec_j, spec_t = jresnet.ResNetSpec(depth, cut), tresnet.ResNetSpec(
        depth, cut)
    want = jresnet.init_params(spec_j, np.random.RandomState(11))
    got = convert.params_to_numpy(
        tresnet.init_params(spec_t, np.random.RandomState(11), "cpu"))
    assert sorted(got) == sorted(want) == spec_t.param_names()
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_fold_resnet_bn_matches_jax():
    jparams, tparams = _pair(tresnet.ResNetSpec(50, "l4"), 12)
    want = jfold(jparams)
    got = convert.params_to_numpy(tfold(tparams))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("depth,cut", [(50, None), (18, None), (50, "l3"),
                                       (50, "l4")])
def test_apply_matches_jax(depth, cut):
    spec = tresnet.ResNetSpec(depth, cut)
    jparams, tparams = _pair(jresnet.ResNetSpec(depth, cut), 13)
    x = _x(14, batch=2)
    want = np.asarray(jresnet.apply(jparams, jnp.asarray(x),
                                    jresnet.ResNetSpec(depth, cut)))
    got = tresnet.apply(tparams, torch.from_numpy(x), spec).numpy()
    assert got.shape == want.shape == (2, spec.out_size(64))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("route,cut", [
    ("v1", None), ("v2", None), ("v1", "l3")])
def test_fused_routes_match_jax_apply(route, cut):
    spec = tresnet.ResNetSpec(50, cut)
    jparams, tparams = _pair(jresnet.ResNetSpec(50, cut), 15)
    x = _x(16)
    want = np.asarray(jresnet.apply(jfold(jparams), jnp.asarray(x),
                                    jresnet.ResNetSpec(50, cut)))
    tfb.reset_launches()
    got = tresnet.FUSED_APPLY[route](tfold(tparams), torch.from_numpy(x),
                                     spec).numpy()
    # on the CPU the wrappers run the plain versions and launch nothing
    assert tfb.launches == {"fused_bottleneck": 0, "fused_bottleneck_flat": 0}
    assert route in tresnet.fused_routes(spec)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_fused_routes_by_spec():
    assert tresnet.fused_routes(tresnet.ResNetSpec(18)) == ("off",)
    assert tresnet.fused_routes(tresnet.ResNetSpec(50, "l4")) == ("off", "v1")
    with pytest.raises(ValueError):
        tresnet.apply_fused_v2({}, torch.zeros(1, 64, 64, 3),
                               tresnet.ResNetSpec(50, "l3"))
