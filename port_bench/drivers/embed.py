"""Bulk embedding: ``EmbeddingNet.embed_batches`` over a pool of uint8
frames in host memory, chunk after chunk, as a bulk job walks a dataset.

Set-up: the encoder's weights drawn from the seed on the device, handed
to an ``EmbeddingNet`` on its card default route, which folds the
BatchNorms as it does for a checkpoint; the frame pool; one chunk
through the pipeline, which builds the kernels and warms every shape of
the window (only whole batches of the traffic's size).  Window: chunks
until ``seconds`` have passed; every frame of every chunk counts.  Check:
a sample of the window's rows, drawn from the seed, against the plain
reference in float32 on the same frames, from its own draw of the
seed's weights (the program may change the ones it was handed).
"""

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import harness, inputs
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import precision
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.ops.cuda import attention as attn
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
from pvr_habitat_tpu_torch.ops.fold_bn import fold_resnet_bn


def install_weights(net, weights):
    """The weights as ``EmbeddingNet`` takes a frozen encoder's
    checkpoint: BatchNorms folded by the port when there are any."""
    net.handle.params = weights
    net.params = (fold_resnet_bn(weights)
                  if any(k.endswith(".running_mean") for k in weights)
                  else weights)


def build(ctx, dtype):
    """The program's encoder on its card default route, with its own
    draw of the seed's weights."""
    enc = ctx.config["encoder"]
    net = EmbeddingNet(enc["embedding_name"], pretrained=False,
                       compute_dtype=dtype, device=ctx.device)
    install_weights(net, inputs.encoder_weights(enc, ctx.seed, ctx.device))
    return ctx.hook("encoder", net)


def _bottleneck_shape(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None,
                      stride=1, **_):
    n, h, _, cin = x.shape
    return dict(n=n, h=h, stride=stride, cin=cin, p=w1.shape[1],
                cout=w3.shape[1], ds=wd is not None,
                itemsize=x.element_size(), dtype=str(x.dtype)[6:])


def _attention_shape(q, k, v, **_):
    n, h, l, d = q.shape
    return dict(n=n, h=h, l=l, d=d, itemsize=q.element_size(),
                dtype=str(q.dtype)[6:])


def trace_kernels(stack, spans):
    """Ranges around the port's kernel wrappers, so that a kernel's
    device time is read whatever implements it."""
    stack.enter_context(harness.patched(
        fb, "fused_bottleneck", spans.wrap(
            "fused_bottleneck", fb.fused_bottleneck, _bottleneck_shape)))
    stack.enter_context(harness.patched(
        attn, "fused_attention", spans.wrap(
            "fused_attention", attn.fused_attention, _attention_shape)))


def run(ctx):
    enc, traffic = ctx.config["encoder"], ctx.traffic
    dtype = getattr(torch, ctx.cell["precision"])
    net = build(ctx, dtype)
    pool = inputs.frame_pool(traffic["pool_frames"], traffic["frame_hw"],
                             ctx.seed, ctx.device)
    chunk, batch = traffic["chunk_frames"], traffic["batch"]
    n_chunks = traffic["pool_frames"] // chunk
    launches = dict(fb.launches, **attn.launches)
    net.embed_batches(pool[:chunk], batch)
    per_forward = {k: (v - launches[k]) * batch // chunk
                   for k, v in dict(fb.launches, **attn.launches).items()}
    ctx.setup_done()

    reservoir = harness.Reservoir(ctx.cell["correct"]["sample_rows"],
                                  inputs.subseed(ctx.seed, "sample"))
    spans, sl = ctx.spans, ctx.profile_slice(1, traffic["profile_chunks"])
    with contextlib.ExitStack() as stack:
        if spans is not None:
            forward = net._forward

            def timed_forward(frames):
                with spans.span("dispatch"):
                    return forward(frames)
            stack.enter_context(harness.patched(net, "_forward",
                                                timed_forward))
            stack.enter_context(harness.patched(
                net.handle, "preprocess",
                spans.wrap("preprocess", net.handle.preprocess)))
            trace_kernels(stack, spans)
        frames, k = 0, 0
        start = time.perf_counter()
        while True:
            lo = (k % n_chunks) * chunk
            if sl:
                sl.before(k)
            out = net.embed_batches(pool[lo:lo + chunk], batch)
            if sl:
                sl.after(k)
            reservoir.add(out, np.arange(lo, lo + chunk))
            frames += chunk
            k += 1
            elapsed = time.perf_counter() - start
            if ctx.window_done(elapsed):
                break
    rate = frames / elapsed
    memory = ctx.memory_peak()

    keys, rows = reservoir.sample()
    route = net.fused
    del net, out
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    weights = inputs.encoder_weights(enc, ctx.seed, ctx.device)
    with precision(tf32=False):
        ref = ref_encoder.embed(torch.as_tensor(pool[keys]).to(ctx.device),
                                weights, enc)
    numbers = compare(rows, ref)
    reading = None
    if sl:
        reading = SimpleNamespace(
            host=spans.host, calls=spans.calls,
            prof=sl.reading(),
            items=sl.items(), frames_per_item=chunk,
            item_s=sl.item_s(frames // chunk, elapsed))
    return dict(
        e2e={"embed_frames_per_s": rate}, attempted=frames,
        failed=int((~np.isfinite(rows).all(axis=1)).sum()),
        memory_peak_bytes=memory, reading=reading,
        info={"route": route, "launches_per_forward": per_forward,
              "chunks": k},
        numbers=numbers,
        checks={name: (numbers[name], limit) for name, limit
                in ctx.cell["correct"]["limits"].items()})


def compare(rows, ref):
    """Numbers of the sampled rows against the reference's: the worst
    row's error over its own norm (``row_err``), the worst and the mean
    row's 1 - cosine (``cos_dist``, ``cos_dist_mean``), the worst
    1 - cosine of the rows less their sample mean (``centered_cos_dist``:
    the frames' differences, with any error common to every row left
    out), and the worst row's norm off the reference's, as a share
    (``norm_gap``: an error that scales rows, which no angle sees)."""
    rows = torch.as_tensor(rows).double().cpu()
    ref = torch.as_tensor(ref).double().cpu()
    err = torch.linalg.norm(rows - ref, dim=1) / torch.linalg.norm(ref, dim=1)
    cos = 1 - torch.nn.functional.cosine_similarity(rows, ref, dim=1)
    centered = 1 - torch.nn.functional.cosine_similarity(
        rows - rows.mean(dim=0), ref - ref.mean(dim=0), dim=1)
    norm = torch.linalg.norm(rows, dim=1) / torch.linalg.norm(ref, dim=1)
    return {"row_err": float(err.max()), "cos_dist": float(cos.max()),
            "cos_dist_mean": float(cos.mean()),
            "centered_cos_dist": float(centered.max()),
            "norm_gap": float((norm - 1).abs().max())}
