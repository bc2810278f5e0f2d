"""The plain reference against the port's plain (``off``) path on the
CPU at a small size: the same weights and inputs give the same answers
(float32 on both sides, so to rounding)."""

import numpy as np
import pytest
import torch

from port_bench import harness, inputs
from port_bench.drivers import embed
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import policy as ref_policy
from port_bench.reference import preprocess as ref_pre
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.train import bc_step, optim

CPU = torch.device("cpu")


def _frames(n, seed=3):
    return torch.as_tensor(inputs.frame_pool(n, 64, seed, CPU))


@pytest.mark.parametrize("config", ["pvr_resnet50", "pvr_mae_base"])
def test_preprocess(config):
    enc = harness.load("configs", config)["encoder"]
    net = EmbeddingNet(enc["embedding_name"], pretrained=False, device="cpu")
    frames = _frames(4)
    port = net.handle.preprocess(frames).permute(0, 3, 1, 2)
    ref = ref_pre.preprocess(frames, enc)
    # a resized value at a rounding tie may land one uint8 level apart
    level = 1.0 / 255 / min(enc["std"])
    diff = (port - ref).abs()
    assert float(diff.max()) <= level * 1.01
    assert float((diff > 1e-5).float().mean()) < 1e-3


@pytest.mark.parametrize("config", ["pvr_resnet50", "pvr_mae_base"])
def test_encoder_against_port_off_path(config):
    enc = harness.load("configs", config)["encoder"]
    weights = inputs.encoder_weights(enc, 5, CPU)
    net = EmbeddingNet(enc["embedding_name"], pretrained=False, device="cpu")
    embed.install_weights(net, weights)
    assert net.fused == "off"
    frames = _frames(2)
    port = net._forward(frames)
    ref = ref_encoder.embed(frames, weights, enc)
    assert float(harness.rel_err_rows(port, ref).max()) < 1e-4


def test_train_steps_against_port():
    pol = dict(harness.load("configs", "pvr_resnet50")["policy"], unroll=6)
    traffic = dict(trajectories=30, min_length=7, max_length=20)
    data = inputs.bc_dataset(traffic, pol["obs_size"], pol["num_actions"],
                             7, CPU)
    w0 = inputs.policy_weights(pol, 7, CPU)
    opt = optim.RMSpropTorch(pol["learning_rate"], alpha=pol["alpha"],
                             eps=pol["epsilon"],
                             max_epochs=pol["max_frames"] // 24 + 1)
    state = bc_step.TrainState(w0, {}, opt.init(w0),
                               torch.Generator().manual_seed(0))
    step = bc_step.make_train_step(opt, max_grad_norm=pol["max_grad_norm"])
    starts = [[0, 40, 90, 150], [10, 60, 120, 200]]
    losses = []
    for s in starts:
        batch = ref_policy.gather(data, s, 6)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    ref = ref_policy.train(w0, data, starts, pol)
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-6)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7)
