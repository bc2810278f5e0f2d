"""The slice as a whole: port ``EmbeddingNet`` vs. the JAX package's on
the same uint8 64x64 frames and the same seeded weights (CPU, f32,
the 1e-3 parity contract)."""

import numpy as np
import pytest
import torch

from pvr_habitat_tpu.models.embedding_net import EmbeddingNet as JaxNet
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet

TOL = 1e-3


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,fused", [("resnet50", "off"),
                                        ("resnet50", "v1"),
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EmbeddingNet("mae_base", pretrained=False, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        EmbeddingNet("resnet18", pretrained=False, device="cpu", fused="v1")
