"""``chip_smoke.py``'s launch table, ``launches_per_forward``, against the
kernel-wrapper calls one real forward makes on the CPU.  There each
wrapper runs its plain version, so a call here is a launch on the card:
the calls are counted by wrapping the wrappers as module attributes, the
way ``port_bench`` counts them."""

import numpy as np
import pytest
import torch

import chip_smoke
from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.models import registry
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.ops.cuda import attention as attn
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
from pvr_habitat_tpu_torch.ops.cuda import layer_norm as ln

WRAPPERS = {"fused_bottleneck": fb, "fused_bottleneck_flat": fb,
            "fused_attention": attn, "layer_norm": ln}
FRAMES = np.random.RandomState(0).randint(0, 256, size=(1, 64, 64, 3),
                                          dtype=np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs in several worker processes on a few cores: torch's
    thread pool stays at one thread here, so that these small forwards
    neither wait on their own threads nor starve the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def calls(monkeypatch):
    """Each kernel wrapper's calls while the test runs.  The encoders are
    built with zero weights (``cm.ShapeRNG`` in place of the seeded
    draws, which would take most of the test's time): which wrappers a
    forward calls depends on the shapes and the route alone."""
    monkeypatch.setattr(np.random, "RandomState",
                        lambda seed=None: cm.ShapeRNG())
    counts = dict.fromkeys(WRAPPERS, 0)
    for kernel, module in WRAPPERS.items():
        def counted(*args, _kernel=kernel, _fn=getattr(module, kernel),
                    **kwargs):
            counts[_kernel] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, kernel, counted)
    return counts


@pytest.mark.parametrize("name,route,dtype", [
    ("resnet50", "v1", torch.float32),
    ("resnet50", "v2", torch.float32),
    ("mae_base", "attention", torch.bfloat16),
    ("clip_vit", "off", torch.float32),
    ("moco_aug_uber_345", "v1", torch.float32)])
def test_launches_per_forward_counts_a_forward(calls, name, route, dtype):
    net = EmbeddingNet(name, pretrained=False, compute_dtype=dtype,
                       device="cpu", fused=route)
    net(FRAMES)
    assert calls == chip_smoke.launches_per_forward(name, route, dtype)


def test_launches_per_forward_counts_the_int8_mae_forward(calls):
    """The int8 serving path on ``attention``, calibrating on its batch,
    as ``ShardedEmbedder(quantize=True)`` runs it (bf16 activations)."""
    int8 = registry.int8_serving_fns("mae_base")
    net = EmbeddingNet("mae_base", pretrained=False, device="cpu")
    x = net.handle.preprocess(torch.from_numpy(FRAMES),
                              out_dtype=torch.bfloat16)
    int8.apply(int8.quantize_params(net.params), x, None, fused="attention")
    assert calls == chip_smoke.launches_per_forward(
        "mae_base", "attention", torch.bfloat16)
