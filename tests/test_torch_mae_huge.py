"""MAE ViT-H/14 (``mae_huge``): the benchmark's configuration against the
port's registry, the port's encoder at ViT-H's head shape (head dim 80,
patch 14, L = 257) against the benchmark's plain reference
(``port_bench/reference/vit.py``) on the CPU, and the ``vit.attn`` /
``vit.mlp`` spans of ``models/vit.py::timm_block`` with their three
readers (``port_bench/metrics/vit_*.embed.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import costs, harness, inputs
from port_bench.program_spans import Call, SpanT, attribute
from port_bench.reference import vit as ref_vit
from port_bench.run import reader
from pvr_habitat_tpu_torch.models import vit
from pvr_habitat_tpu_torch.ops.cuda import attention as attn
from pvr_habitat_tpu_torch.utils import profiling

CONFIG = harness.load("configs", "pvr_mae_huge")
SEED = 2 ** 31 + 17
F32_TOL = 1e-5      # f32, the same math in another summation order
BF16_COS = 0.999    # bf16 activations and weights, tanh GELU: per row
READERS = ("vit_attn_device_ms.embed", "vit_mlp_device_ms.embed",
           "vit_block_launches.embed")


def test_config_is_the_registrys_mae_huge():
    enc = CONFIG["encoder"]
    assert enc["embedding_name"] == "mae_huge" and enc["arch"] == "vit"
    assert (enc["embed_dim"], enc["depth"], enc["num_heads"],
            enc["patch"]) == vit.MAE_CONFIGS["mae_huge"]
    assert enc["out_size"] == enc["embed_dim"] == CONFIG["policy"][
        "obs_size"]
    assert (enc["input_hw"] // enc["patch"]) ** 2 + 1 == 257
    assert enc["embed_dim"] // enc["num_heads"] == 80
    assert CONFIG["reduced"] == []
    keys = [key for key, _, _ in inputs.vit_specs(enc)] + ["pos_embed"]
    assert len(keys) == len(set(keys))
    assert set(keys) == vit.mae_param_names("mae_huge")
    # 630.4 M parameters (the position embedding is fixed), 334.6 GFLOP
    params = sum(int(np.prod(shape)) for _, shape, _ in inputs.vit_specs(enc))
    assert params == pytest.approx(630.4e6, rel=1e-3)
    assert costs.encoder_flop_per_frame(enc) == pytest.approx(334.6e9,
                                                              rel=1e-3)


def test_position_embeddings_agree():
    ours = vit.sincos_pos_embed_2d(1280, 16, cls_token=True)[None]
    theirs = inputs.sincos_pos_embed(1280, 16).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def _small():
    """ViT-H's head (2 heads of 80) and patch at width 160, depth 2."""
    enc = dict(CONFIG["encoder"], embed_dim=160, depth=2, num_heads=2,
               out_size=160)
    weights = inputs.encoder_weights(enc, SEED, torch.device("cpu"))
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator()
                    .manual_seed(5))
    return enc, weights, x


def _apply(weights, x, enc, dtype, fused):
    return vit.mae_apply(weights, x.permute(0, 2, 3, 1).to(dtype),
                         depth=enc["depth"], num_heads=enc["num_heads"],
                         patch=enc["patch"], fused=fused).float()


def test_small_encoder_against_the_reference(monkeypatch):
    enc, weights, x = _small()
    with torch.no_grad():
        ref = ref_vit.forward(x, weights, enc)
        got = _apply(weights, x, enc, torch.float32, "off")
        err = torch.linalg.norm(got - ref, dim=1) / torch.linalg.norm(ref,
                                                                     dim=1)
        assert float(err.max()) <= F32_TOL
        calls = []
        kernel = attn.fused_attention

        def spy(q, k, v):
            calls.append(tuple(q.shape))
            return kernel(q, k, v)
        monkeypatch.setattr(attn, "fused_attention", spy)
        low = _apply(weights, x, enc, torch.bfloat16, "attention")
    assert calls == [(2, 2, 257, 80)] * enc["depth"]
    cos = torch.nn.functional.cosine_similarity(low, ref, dim=1)
    assert float(cos.min()) >= BF16_COS


def test_block_spans_once_a_block():
    enc, weights, x = _small()
    first = max((s.id for s in profiling.spans()), default=-1) + 1
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        _apply(weights, x, enc, torch.bfloat16, "attention")
    recorded = profiling.spans(first)
    names = [s.name for s in recorded]
    assert names.count("vit.attn") == names.count("vit.mlp") == enc["depth"]
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        if s.name == "kernel.fused_attention":
            assert by_id[s.parent].name == "vit.attn"
        elif s.name == "vit.linear":
            assert by_id[s.parent].name in ("vit.attn", "vit.mlp")
        elif s.name.startswith("vit."):
            assert s.parent is None
    assert names.count("vit.linear") == 4 * enc["depth"]
    halves = [n for n in names if n in ("vit.attn", "vit.mlp")]
    assert halves == ["vit.attn", "vit.mlp"] * enc["depth"]


def _ctx(rows, depth):
    return SimpleNamespace(
        slice=SimpleNamespace(light=object(), full=object(),
                              program_rows=rows),
        config={"encoder": {"depth": depth}})


def test_readers_on_made_up_spans():
    """Two batches of a two-block encoder: each attention half launches
    3 kernels of 1 us, each MLP half 2 of 4 us; one launch outside the
    blocks (the final norm) counts in neither."""
    main, spans, calls, kernels, corr = 7, [], [], {}, iter(range(1000))
    sid = iter(range(1000))
    for batch in range(2):
        t0 = 1000.0 * batch
        enc_id = next(sid)
        spans.append(SpanT(enc_id, "embed.encoder", main, t0, t0 + 900,
                           None))
        for block in range(2):
            for half, start, n, dev in (("vit.attn", 100, 3, 1e-6),
                                        ("vit.mlp", 200, 2, 4e-6)):
                lo = t0 + start + 300 * block
                spans.append(SpanT(next(sid), half, main, lo, lo + 90,
                                   enc_id))
                for i in range(n):
                    c = next(corr)
                    calls.append(Call(main, lo + 10 + i, c,
                                      "cudaLaunchKernel"))
                    kernels[c] = [dev]
        c = next(corr)
        calls.append(Call(main, t0 + 850, c, "cudaLaunchKernel"))
        kernels[c] = [9e-6]
    ctx = _ctx(attribute(spans, calls, kernels, 5000.0), depth=2)
    got = {name: reader(name)(None, ctx) for name in READERS}
    assert got["vit_attn_device_ms.embed"] == pytest.approx(2 * 3 * 1e-3)
    assert got["vit_mlp_device_ms.embed"] == pytest.approx(2 * 2 * 4e-3)
    assert got["vit_block_launches.embed"] == pytest.approx(5.0)


def test_readers_find_nothing_without_the_spans():
    """A program without the block spans (the parent of this change, or
    a ResNet) reads as None, not 0."""
    spans = [SpanT(0, "embed.encoder", 7, 0.0, 100.0, None)]
    calls = [Call(7, 10.0, 1, "cudaLaunchKernel")]
    ctx = _ctx(attribute(spans, calls, {1: [1e-6]}, 500.0), depth=32)
    assert all(reader(name)(None, ctx) is None for name in READERS)
    assert all(reader(name)(None, _ctx(None, 32)) is None
               for name in READERS)


@pytest.mark.slow
def test_full_width_against_the_reference():
    """ViT-H/14 at its published widths and depth, two frames, f32."""
    enc = CONFIG["encoder"]
    weights = inputs.encoder_weights(enc, SEED, torch.device("cpu"))
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator()
                    .manual_seed(6))
    with torch.no_grad():
        ref = ref_vit.forward(x, weights, enc)
        got = _apply(weights, x, enc, torch.float32, "off")
    err = torch.linalg.norm(got - ref, dim=1) / torch.linalg.norm(ref, dim=1)
    assert float(err.max()) <= F32_TOL
