"""The rest of the encoder zoo in the port against the JAX package (CPU,
f32 unless stated): the CLIP towers at a narrow width (1e-4), the
seeded inits draw for draw, and at full width ``clip_vit``,
``clip_rn50``, ``maskrcnn_l3`` and the MoCo uber fusion
``moco_aug_uber_345`` through both packages' ``EmbeddingNet`` on 2
frames, with the weights loaded from checkpoints in the reference's
layouts (OpenAI ``visual.*``, detectron2 ``model`` -> ``backbone.*``,
MoCo ``state_dict`` -> ``module.encoder_q.*``) that
``tools/zoo_checkpoints.py`` writes: the seeded init (the JAX package's
draws) with trained-like BN statistics, which both packages fold.  1e-3,
and atol 2e-3 / rtol 1e-3 for the deep convnets, as
``tests/test_vit_clip_maskrcnn.py`` allows JAX against its torch
oracles.  Then the uber fusion on ``v1`` (the
kernels' plain versions here) against ``off`` at 1e-4, bf16 against f32
by per-frame cosine, and the zoo's names and output sizes."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pvr_habitat_tpu.models import clip as jclip
from pvr_habitat_tpu.models import registry as jregistry
from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu_torch.models import clip, convert, registry
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.tools import zoo_checkpoints

ZOO = ("clip_vit", "clip_rn50", "maskrcnn_l3", "moco_aug_uber_345")
# (atol, rtol) of a full-width encoder, port vs JAX
FULL_TOL = {"clip_vit": (1e-3, 1e-3), "clip_rn50": (2e-3, 1e-3),
            "maskrcnn_l3": (2e-3, 1e-3), "moco_aug_uber_345": (2e-3, 1e-3)}
VIT_NARROW = dict(width=96, layers=2, heads=4, patch=32,
                  input_resolution=224, output_dim=64)
RN50_NARROW = dict(layers=(1, 1, 1, 1), width=16, output_dim=32, heads=4,
                   input_resolution=64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on a few cores: torch's
    and BLAS's thread pools stay small here (the results do not depend
    on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(threads)


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, 64, 64, 3), dtype=np.uint8)


def _x(n, hw, seed):
    return (np.random.RandomState(seed).randn(n, hw, hw, 3) * 0.5).astype(
        np.float32)


def _port(flat):
    return convert.params_from_numpy(
        {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def test_clip_vit_narrow_matches_jax():
    want_params = jclip.init_clip_vit_params(np.random.RandomState(1),
                                             VIT_NARROW)
    got_params = clip.init_clip_vit_params(np.random.RandomState(1),
                                           VIT_NARROW, device="cpu")
    # the init draw for draw (the patch conv bridged HWIO -> OIHW)
    for key, value in _port(want_params).items():
        torch.testing.assert_close(got_params[key], value, atol=0, rtol=0)
    x = _x(2, 224, seed=1)
    want = jclip.clip_vit_apply(want_params, jnp.asarray(x), cfg=VIT_NARROW)
    got = clip.clip_vit_apply(got_params, torch.from_numpy(x),
                              cfg=VIT_NARROW)
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_clip_rn50_narrow_matches_jax():
    port_init = clip.init_clip_rn50_params(np.random.RandomState(2),
                                           RN50_NARROW, device="cpu")
    for key, value in _port(jclip.init_clip_rn50_params(
            np.random.RandomState(2), RN50_NARROW)).items():
        torch.testing.assert_close(port_init[key], value, atol=0, rtol=0)
    params = zoo_checkpoints.trained_like(port_init, seed=3)  # eval BN
    x = _x(2, 64, seed=2)
    want = jclip.clip_rn50_apply(
        {k: jnp.asarray(v) for k, v in
         convert.params_to_numpy(params).items()}, jnp.asarray(x),
        cfg=RN50_NARROW)
    got = clip.clip_rn50_apply(params, torch.from_numpy(x),
                               cfg=RN50_NARROW)
    assert got.shape == want.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ZOO)
def test_seeded_init_matches_jax(name):
    """No checkpoint: both packages build the same name-seeded weights
    (the uber fusion's under ``models.{i}.``, each from its own name)."""
    want = jregistry.build_encoder(name, pretrained=False)
    got = registry.build_encoder(name, pretrained=False, device="cpu")
    assert got.out_size == want.out_size
    assert got.sub_names == want.sub_names
    assert set(got.params) == set(want.params)
    for key, value in _port(want.params).items():
        torch.testing.assert_close(got.params[key], value, atol=0, rtol=0,
                                   msg=key)


@pytest.mark.parametrize("name", ZOO)
def test_full_width_checkpoint_embeddings_match_jax(name, tmp_path):
    zoo_checkpoints.write(name, str(tmp_path), seed=5)
    frames = _frames(2, seed=6)
    with warnings.catch_warnings():
        # a missing file would warn and fall back to the seeded init
        warnings.simplefilter("error")
        jnet = JaxNet(name, pretrained=True, checkpoint_dir=str(tmp_path))
        net = EmbeddingNet(name, pretrained=True,
                           checkpoint_dir=str(tmp_path), device="cpu")
    # both loaded the same weights
    loaded = convert.params_to_numpy(net.handle.params)
    assert loaded.keys() == jnet.handle.params.keys()
    for key, value in jnet.handle.params.items():
        np.testing.assert_array_equal(loaded[key], np.asarray(value), key)
    want = jnet(frames)
    got = net(frames)
    assert got.shape == want.shape == (2, jnet.out_size)
    atol, rtol = FULL_TOL[name]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_uber_v1_matches_off_and_bf16_cosine():
    """The uber fusion on ``v1`` runs each constituent's bottleneck blocks
    through the kernels' wrappers (their plain versions on the CPU): 1e-4
    against ``off``; bf16 per-frame cosine > 0.99 against f32."""
    frames = _frames(2, seed=7)
    off = EmbeddingNet("moco_aug_uber_345", pretrained=False, device="cpu")
    assert off.fused == "off" and off.handle.fused_routes == ("off", "v1")
    want = off(frames)
    v1 = EmbeddingNet("moco_aug_uber_345", pretrained=False, device="cpu",
                      fused="v1")
    np.testing.assert_allclose(v1(frames), want, atol=1e-4, rtol=1e-4)
    bf16 = EmbeddingNet("moco_aug_uber_345", pretrained=False, device="cpu",
                        fused="v1", compute_dtype=torch.bfloat16)
    assert _min_cosine(bf16(frames), want) > 0.99
    with pytest.raises(ValueError, match="fused"):
        EmbeddingNet("moco_aug_uber_345", pretrained=False, device="cpu",
                     fused="v2")


def _min_cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b,
                                                                     axis=1)
    return cos.min()


@pytest.mark.parametrize("name", ("clip_vit", "clip_rn50", "maskrcnn_l3"))
def test_bf16_cosine_against_f32(name):
    frames = _frames(2, seed=8)
    want = EmbeddingNet(name, pretrained=False, device="cpu")(frames)
    net = EmbeddingNet(name, pretrained=False, device="cpu",
                       compute_dtype=torch.bfloat16)
    assert net.fused == "off" and net.handle.fused_routes == ("off",)
    assert _min_cosine(net(frames), want) > 0.99


def test_zoo_is_complete():
    assert registry.all_encoder_names() == jregistry.all_encoder_names()
    assert registry.all_uber_names() == jregistry.all_uber_names()
    for name in registry.all_uber_names():
        assert registry.uber_constituents(name) == \
            jregistry.uber_constituents(name)


def test_uber_bases_are_not_fusions():
    """moco_aug_uber and moco_croponly_uber are MoCo bases trained on uber
    data (one full trunk), not fusions."""
    for name in ("moco_aug_uber", "moco_croponly_uber"):
        handle = registry.build_encoder(name, pretrained=False, device="cpu")
        assert handle.out_size == 2048 and handle.sub_names == ()
        assert handle.fused_routes == ("off", "v1", "v2")
