"""The slices as a whole: port ``EmbeddingNet`` vs. the JAX package's on
the same uint8 64x64 frames and the same seeded weights (CPU, f32,
the 1e-3 parity contract), for ResNet-50 and for mae_base at full width
and depth.

mae_base runs the whole path, frames to embedding, on both sides: the
bicubic preprocess flips about one element in 3e5 by one quantum
(ROADMAP queue 3), and after 12 blocks that still stays far inside 1e-3
on these frames, so the encoders need not be compared on a shared
preprocessed input."""

import numpy as np
import pytest
import torch

from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu_torch.models import vit
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.models.registry import (CHECKPOINT_FILES,
                                                   build_encoder)
from tests.torch_ref import vit as oracle_vit

TOL = 1e-3


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,fused", [("resnet50", "off"),
                                        ("resnet50", "v1"),
                                        ("mae_base", "off"),
                                        ("random", "off")])
def test_embedding_net_matches_jax(name, fused):
    frames = _frames(3)
    jnet = JaxNet(name, pretrained=False)
    tnet = EmbeddingNet(name, pretrained=False, device="cpu", fused=fused)
    assert tnet.out_size == jnet.out_size
    want = jnet(frames)
    got = tnet(frames)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the bulk path, with a ragged last batch
    np.testing.assert_allclose(tnet.embed_batches(frames, 2), want,
                               atol=TOL, rtol=TOL)
    # online batch of one, squeezed like the reference
    one = tnet(frames[:1])
    assert one.shape == (jnet.out_size,)
    np.testing.assert_allclose(one, want[0], atol=TOL, rtol=TOL)


def test_chunking_at_max_bucket_matches_one_call():
    frames = _frames(5, seed=1)
    net = EmbeddingNet("random", pretrained=False, device="cpu", max_bucket=2)
    whole = EmbeddingNet("random", pretrained=False, device="cpu")(frames)
    np.testing.assert_allclose(net(frames), whole, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tar_weights_interoperate(tmp_path, writer):
    frames = _frames(2, seed=2)
    path = str(tmp_path / "resnet50.tar")
    jnet = JaxNet("resnet50", pretrained=False)
    tnet = EmbeddingNet("resnet50", pretrained=False, device="cpu")
    # perturb the writer's weights so that loading them is observable
    if writer == "jax":
        jnet.params = {k: v * 1.01 for k, v in jnet.params.items()}
        jnet.save(path)
        tnet.load(path)
    else:
        tnet.params = {k: v * 1.01 for k, v in tnet.params.items()}
        tnet.save(path)
        jnet.load(path)
    np.testing.assert_allclose(tnet(frames), jnet(frames), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_dicts_interoperate(writer):
    frames = _frames(2, seed=3)
    jnet = JaxNet("resnet50", pretrained=False)
    tnet = EmbeddingNet("resnet50", pretrained=False, device="cpu")
    # perturb the writer's weights so that loading them is observable
    if writer == "jax":
        jnet.params = {k: v * 1.01 for k, v in jnet.params.items()}
        tnet.load_state_dict(jnet.state_dict())
    else:
        tnet.params = {k: v * 1.01 for k, v in tnet.params.items()}
        jnet.load_state_dict(tnet.state_dict())
    np.testing.assert_allclose(tnet(frames), jnet(frames), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", ["resnet50", "mae_base"])
def test_state_dict_has_the_jax_layout(name):
    want = JaxNet(name, pretrained=False).state_dict()
    got = EmbeddingNet(name, pretrained=False, device="cpu").state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        assert isinstance(value, np.ndarray) and value.dtype == np.float32
        assert value.shape == want[key].shape, key


def test_true_state_passthrough():
    net = EmbeddingNet("true_state", device="cpu")
    obs = np.arange(12, dtype=np.float32).reshape(1, 12)
    np.testing.assert_array_equal(net(obs), obs.squeeze())
    assert net.out_size == 12


def test_no_device_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbeddingNet("random", pretrained=False)


def test_unported_encoders_and_routes_raise():
    with pytest.raises(NotImplementedError,
                       match="Requested model not available"):
        EmbeddingNet("clip_vit_b16", pretrained=False, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        EmbeddingNet("moco_aug_uber_34", pretrained=False, device="cpu",
                     fused="v2")
    with pytest.raises(ValueError, match="fused"):
        EmbeddingNet("resnet18", pretrained=False, device="cpu", fused="v1")
    with pytest.raises(ValueError, match="fused"):
        EmbeddingNet("mae_base", pretrained=False, device="cpu", fused="v1")
    with pytest.raises(ValueError, match="fused"):
        EmbeddingNet("mae_base", pretrained=False, device="cpu", train=True,
                     fused="attention")


@pytest.mark.parametrize("name,routes", [
    ("resnet50", ("off", "v1", "v2", "hybrid")),
    ("mae_base", ("off", "attention")),
    ("random", ("off",))])
def test_routes_and_cpu_default(name, routes):
    """The card's default is a handle's first kernel route (v1, attention);
    on the CPU it is off."""
    net = EmbeddingNet(name, pretrained=False, device="cpu")
    assert net.handle.fused_routes == routes
    assert net.fused == "off"


def _mae_checkpoint(tmp_path, with_pos_embed=True):
    """An MAE pretraining checkpoint as the reference ships it: {'model':
    state_dict} with the decoder's keys, which the encoder ignores."""
    torch.manual_seed(0)
    model = oracle_vit.MAEEncoder(dim=768, depth=12, heads=12, patch=16)
    model.eval()
    state = dict(model.state_dict())
    state["mask_token"] = torch.zeros(1, 1, 512)
    state["decoder_pos_embed"] = torch.zeros(1, 197, 512)
    state["decoder_embed.weight"] = torch.zeros(512, 768)
    state["decoder_blocks.0.norm1.weight"] = torch.zeros(512)
    state["decoder_pred.weight"] = torch.zeros(768, 512)
    state["decoder_norm.weight"] = torch.zeros(512)
    if not with_pos_embed:
        del state["pos_embed"]
    torch.save({"model": state}, str(tmp_path / CHECKPOINT_FILES["mae_base"]))
    return model


def test_mae_checkpoint_with_decoder_keys_loads(tmp_path):
    model = _mae_checkpoint(tmp_path)
    handle = build_encoder("mae_base", pretrained=True,
                           checkpoint_dir=str(tmp_path), device="cpu")
    assert set(handle.params) == vit.mae_param_names("mae_base")
    x = (np.random.RandomState(4).randn(1, 224, 224, 3) * 0.3).astype(
        np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        got = handle.apply_fn(handle.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_mae_checkpoint_without_pos_embed_regenerates_it(tmp_path):
    model = _mae_checkpoint(tmp_path, with_pos_embed=False)
    handle = build_encoder("mae_base", pretrained=True,
                           checkpoint_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(
        handle.params["pos_embed"].numpy(),
        vit.sincos_pos_embed_2d(768, 14, cls_token=True)[None])
    torch.testing.assert_close(handle.params["blocks.11.mlp.fc2.weight"],
                               model.state_dict()["blocks.11.mlp.fc2.weight"])


def test_mae_bad_checkpoint_fails_fast(tmp_path, monkeypatch):
    monkeypatch.delenv("PVR_TPU_CKPT_FALLBACK", raising=False)
    torch.save({"model": {"cls_token": torch.zeros(1, 1, 768)}},
               str(tmp_path / CHECKPOINT_FILES["mae_base"]))
    with pytest.raises(RuntimeError, match="missing"):
        build_encoder("mae_base", pretrained=True,
                      checkpoint_dir=str(tmp_path), device="cpu")
