"""Per-trajectory embedding: one ``EmbeddingNet.__call__`` a trajectory,
as ``data/formats.py::read_png_trajectories(embed_fn=...)`` calls it on
``save_embedded_obs``'s default path (``--source png``), in float32.

Set-up: the encoder's weights drawn from the seed on the device, handed
to an ``EmbeddingNet`` on its card default route (``embed.build``); the
frame pool in host memory, cut in order into trajectories of the lengths
``inputs.trajectory_lengths`` gives (the same multiset for every seed,
in an order drawn from it); one call at each distinct length, which
builds the kernels and warms every shape of the window.  Window: the
trajectories in order, wrapping, until ``seconds`` have passed; every
frame counts.  Check: a sample of the window's rows, drawn from the
seed, against the plain reference in float32 on the same frames, from
its own draw of the seed's weights; the control is the reference in
TF32 in the program's place.  A trajectory whose answer does not have
one finite row a frame counts its frames as failed, with rows of NaN.
"""

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import harness, inputs
from port_bench.drivers import embed
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import precision
from pvr_habitat_tpu_torch.ops.cuda import attention as attn
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb


def _launches():
    return dict(fb.launches, **attn.launches)


def _rows(out, n, width):
    """The call's answer as (n, width) float32 rows; NaN where it has
    another size."""
    rows = np.asarray(out, np.float32)
    if rows.size != n * width:
        return np.full((n, width), np.nan, np.float32)
    return rows.reshape(n, width)


def run(ctx):
    enc, traffic = ctx.config["encoder"], ctx.traffic
    dtype = getattr(torch, ctx.cell["precision"])
    net = embed.build(ctx, dtype)
    pool = inputs.frame_pool(traffic["pool_frames"], traffic["frame_hw"],
                             ctx.seed, ctx.device)
    lengths = inputs.trajectory_lengths(traffic, ctx.seed)
    starts = np.cumsum(lengths) - lengths
    for n in np.unique(lengths):
        net(pool[:n])
    ctx.setup_done()

    before = _launches()
    reservoir = harness.Reservoir(ctx.cell["correct"]["sample_rows"],
                                  inputs.subseed(ctx.seed, "sample"))
    spans = ctx.spans
    sl = ctx.profile_slice(1, traffic["profile_trajectories"])
    sizes, failed = [], 0
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
            embed.trace_kernels(stack, spans)
        k = 0
        start = time.perf_counter()
        while True:
            j = k % len(lengths)
            lo, n = int(starts[j]), int(lengths[j])
            if sl:
                sl.before(k)
            out = net(pool[lo:lo + n])
            if sl:
                sl.after(k)
            rows = _rows(out, n, net.out_size)
            failed += int((~np.isfinite(rows).all(axis=1)).sum())
            reservoir.add(rows, np.arange(lo, lo + n))
            sizes.append(n)
            k += 1
            elapsed = time.perf_counter() - start
            if ctx.window_done(elapsed):
                break
    frames = sum(sizes)
    rate = frames / elapsed
    memory = ctx.memory_peak()
    per_trajectory = {name: (count - before[name]) / k
                      for name, count in _launches().items()}

    keys, rows = reservoir.sample()
    route = net.fused
    del net, out
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    weights = inputs.encoder_weights(enc, ctx.seed, ctx.device)
    sampled = torch.as_tensor(pool[keys]).to(ctx.device)
    with precision(tf32=False):
        ref = ref_encoder.embed(sampled, weights, enc)
    numbers = embed.compare(rows, ref)
    reading = None
    if sl:
        # Items are frames: the trajectories of the slices differ in
        # length from the rest of the window's.
        light = sum(sizes[sl.first:sl.first + sl.count])
        rest = frames - sum(sizes[sl.first:sl.first + 2 * sl.count])
        reading = SimpleNamespace(
            host=spans.host, calls=spans.calls,
            prof=sl.reading(),
            items=light, frames_per_item=1,
            item_s=((elapsed - sl.overhead_s) / rest
                    if rest > 0 and elapsed > sl.overhead_s else None))
    return dict(
        e2e={"embed_frames_per_s": rate}, attempted=frames, failed=failed,
        memory_peak_bytes=memory, reading=reading,
        info={"route": route, "launches_per_trajectory": per_trajectory,
              "trajectories": k, "passes": k / len(lengths)},
        numbers=numbers,
        checks={name: (numbers[name], limit) for name, limit
                in ctx.cell["correct"]["limits"].items()},
        control=lambda: control(sampled, weights, enc, ref))


def control(frames, weights, enc, ref):
    """The control's numbers: the reference in TF32 in the program's
    place."""
    with precision(tf32=True):
        low = ref_encoder.embed(frames, weights, enc)
    return embed.compare(low, ref)
