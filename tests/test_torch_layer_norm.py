"""The LayerNorm wrapper (``ops/cuda/layer_norm.py``) on the CPU:
``models/common.py::layer_norm`` runs the plain version,
``layer_norm_ref`` (the op-by-op body it had before the kernel existed,
which tests/test_torch_vit.py holds to the JAX package); the argument
checks that pick what the kernel reads and refuse what it cannot take; the
build's entry for its source; its ``kernel.layer_norm`` spans in a ViT
forward; and their reader ``layer_norm_device_ms.embed``.  The kernel
itself is held against the plain version in
tests/test_torch_cuda_kernels.py, on the card."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import harness, inputs
from port_bench.program_spans import Call, SpanT, attribute
from port_bench.run import reader
from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.models import vit
from pvr_habitat_tpu_torch.ops.cuda import build
from pvr_habitat_tpu_torch.ops.cuda import layer_norm as ln
from pvr_habitat_tpu_torch.utils import profiling

READER = "layer_norm_device_ms.embed"


def _params(d, seed):
    rng = np.random.RandomState(seed)
    return {"n.weight": torch.from_numpy(
                (1 + 0.05 * rng.randn(d)).astype(np.float32)),
            "n.bias": torch.from_numpy(
                (0.05 * rng.randn(d)).astype(np.float32))}


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 9, 96), (2, 197, 768)])
def test_cpu_layer_norm_gives_the_bits_it_gave_before(shape, dtype, eps):
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
    x = x.to(dtype)
    p = _params(shape[-1], seed=3)
    before = dict(ln.launches)
    got = cm.layer_norm(x, p, "n", eps=eps)
    assert ln.launches == before
    want = ln.layer_norm_ref(x, p["n.weight"], p["n.bias"], eps)
    assert got.dtype == dtype and torch.equal(got, want)


def test_other_devices_are_refused():
    x = torch.zeros(2, 768, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ln.layer_norm(x, torch.ones(768), torch.zeros(768))


def _aligned(rows):
    size = rows.element_size()
    return (rows.stride(1) == 1 and rows.data_ptr() % 16 == 0
            and (rows.shape[0] == 1 or rows.stride(0) * size % 16 == 0))


def _views():
    """(label, x, whether the kernel reads x where it lies)."""
    bf16, f32 = torch.bfloat16, torch.float32
    wide = torch.zeros(6, 772, dtype=bf16)
    return [
        ("dense", torch.zeros(2, 3, 768, dtype=bf16), True),
        ("one row", torch.zeros(1, 1024, dtype=bf16), True),
        ("cls rows", torch.zeros(4, 5, 768, dtype=bf16)[:, 0, :], True),
        ("cls rows f32", torch.zeros(4, 5, 1280, dtype=f32)[:, 0, :], True),
        ("transposed", torch.zeros(768, 6, dtype=bf16).T, False),
        ("start 2 bytes off", torch.zeros(6, 769, dtype=bf16)[:, 1:], False),
        ("rows 1544 bytes apart", wide[:, :768], False),
        ("rows 3088 bytes apart", wide.float()[:, :768], True),
        ("heads first", torch.zeros(4, 5, 768, dtype=bf16).transpose(0, 1),
         False),
    ]


@pytest.mark.parametrize("label,x,in_place", _views(),
                         ids=[v[0] for v in _views()])
def test_kernel_rows_by_shape_stride_and_dtype(label, x, in_place):
    d = x.shape[-1]
    rows = ln.kernel_rows(x, torch.ones(d), torch.zeros(d))
    assert rows.shape == (x.numel() // d, d) and _aligned(rows)
    assert torch.equal(rows, x.reshape(-1, d))
    assert (rows.data_ptr() == x.data_ptr()) is in_place, label


@pytest.mark.parametrize("x,w,b,match", [
    (torch.zeros(2, 768, dtype=torch.float16), None, None, "dtype"),
    (torch.zeros(2, 768, dtype=torch.float64), None, None, "dtype"),
    (torch.zeros(2, 640), None, None, "width"),
    (torch.zeros(2, 96), None, None, "width"),
    (torch.zeros(2, 256), None, None, "width"),
    (torch.zeros(2, 512), None, None, "width"),
    (torch.zeros(()), None, None, "width"),
    (torch.zeros(2, 768), torch.ones(1024), None, "expected"),
    (torch.zeros(2, 768), torch.ones(768, dtype=torch.bfloat16), None,
     "float32 or x's dtype"),
    (torch.zeros(2, 768, dtype=torch.bfloat16),
     torch.ones(768, dtype=torch.bfloat16), torch.zeros(768),
     "both the same"),
    (torch.zeros(2, 768), None, torch.zeros(768, device="meta"), "on meta"),
])
def test_kernel_rows_refuses_what_the_kernel_does_not_take(x, w, b, match):
    d = x.shape[-1] if x.dim() else 1
    w = torch.ones(d) if w is None else w
    b = torch.zeros(d) if b is None else b
    with pytest.raises(ValueError, match=match):
        ln.kernel_rows(x, w, b)


def test_layer_norm_shape():
    x = torch.zeros(3, 257, 1280, dtype=torch.bfloat16)
    assert ln.layer_norm_shape(x) == dict(rows=771, d=1280, itemsize=2,
                                          dtype="bfloat16")


def test_build_has_the_library_and_hashes_its_source(tmp_path):
    assert "layer_norm_launch" in build.SIGNATURES["layer_norm"]
    default = build.library_path("layer_norm")
    assert default.name.startswith("layer_norm-")
    source = (build.CSRC / "layer_norm.cu").read_bytes()
    same = tmp_path / "layer_norm.cu"
    same.write_bytes(source)
    assert build.library_path("layer_norm", same) == default
    edited = tmp_path / "edited.cu"
    edited.write_bytes(source + b"\n")
    assert build.library_path("layer_norm", edited) != default


@pytest.mark.parametrize("needs_grad", ["x", "w", "b"])
def test_kernel_rows_refuses_what_autograd_would_differentiate(needs_grad):
    """The kernel has no backward: it must not cut a graph silently."""
    t = dict(x=torch.zeros(2, 768), w=torch.ones(768), b=torch.zeros(768))
    t[needs_grad].requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        ln.kernel_rows(t["x"], t["w"], t["b"])
    with torch.no_grad():
        assert ln.kernel_rows(t["x"], t["w"], t["b"]).shape == (2, 768)


def test_plain_version_keeps_the_graph_on_the_cpu():
    x = torch.randn(3, 768, requires_grad=True)
    w, b = torch.ones(768, requires_grad=True), torch.zeros(768)
    ln.layer_norm(x, w, b).sum().backward()
    assert x.grad is not None and w.grad is not None


def test_spans_in_a_vit_forward():
    """Two a block, inside ``vit.attn`` and ``vit.mlp``, and the final
    norm's outside them, each with its call's shape."""
    enc = dict(harness.load("configs", "pvr_mae_base")["encoder"],
               embed_dim=64, depth=2, num_heads=2, out_size=64)
    weights = inputs.encoder_weights(enc, 7, torch.device("cpu"))
    x = torch.randn(1, 224, 224, 3, generator=torch.Generator()
                    .manual_seed(1))
    first = max((s.id for s in profiling.spans()), default=-1) + 1
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        vit.mae_apply(weights, x, depth=2, num_heads=2, patch=enc["patch"])
    recorded = profiling.spans(first)
    by_id = {s.id: s for s in recorded}
    norms = [s for s in recorded if s.name == "kernel.layer_norm"]
    parents = [by_id[s.parent].name if s.parent in by_id else None
               for s in norms]
    assert parents == ["vit.attn", "vit.mlp"] * 2 + [None]
    assert all(s.attrs["shape"] == dict(rows=197, d=64, itemsize=4,
                                        dtype="float32") for s in norms)


def _ctx(rows):
    return SimpleNamespace(slice=SimpleNamespace(
        light=object(), full=object(), program_rows=rows))


def test_reader_on_made_up_spans():
    """Two batches of an encoder with two LayerNorms of 3 us each inside
    one block span and a final one of 5 us; a launch outside the norms
    counts for none of them."""
    main, spans, calls, kernels = 7, [], [], {}
    ids, corr = iter(range(1000)), iter(range(1000))

    def launch(t, seconds):
        c = next(corr)
        calls.append(Call(main, t, c, "cudaLaunchKernel"))
        kernels[c] = [seconds]

    for batch in range(2):
        t0 = 1000.0 * batch
        enc = next(ids)
        spans.append(SpanT(enc, "embed.encoder", main, t0, t0 + 900, None))
        block = next(ids)
        spans.append(SpanT(block, "vit.attn", main, t0 + 100, t0 + 500, enc))
        for lo, seconds, parent in ((t0 + 110, 3e-6, block),
                                    (t0 + 300, 3e-6, block),
                                    (t0 + 700, 5e-6, enc)):
            spans.append(SpanT(next(ids), "kernel.layer_norm", main, lo,
                               lo + 20, parent))
            launch(lo + 5, seconds)
        launch(t0 + 200, 9e-6)
    ctx = _ctx(attribute(spans, calls, kernels, 5000.0))
    assert reader(READER)(None, ctx) == pytest.approx(11e-3)


def test_reader_finds_nothing_without_the_spans():
    """The parent of the kernel has no ``kernel.layer_norm`` span: None,
    not 0."""
    spans = [SpanT(0, "embed.encoder", 7, 0.0, 100.0, None)]
    calls = [Call(7, 10.0, 1, "cudaLaunchKernel")]
    assert reader(READER)(None, _ctx(attribute(spans, calls, {1: [1e-6]},
                                               500.0))) is None
    assert reader(READER)(None, _ctx(None)) is None
