"""The control and the planted faults, as hooks on a run's timed path.

None of these runs in the benchmark's own runs.  ``port_bench.calibrate``
reads them on the chip, at the cell's size, for the limits; the tests
drive a run with each and see ``correct`` come out false.

- ``int8``: the embed cells' control, the program's own W8A8 path
  (``registry.int8_serving_fns``, the path of ``ShardedEmbedder(
  quantize=True)``) switched on in place of the bf16 forward.  The f32
  cells' control, the reference in TF32, needs no hook: each driver's
  result carries it as ``control``.
- ``stale``: a step that returns its state unchanged (the encoder gives
  the previous batch's rows again; the train step returns the state it
  got; the policy returns the LSTM state it got).
- ``half_batch``: half of the batch left out (the encoder's second half
  of rows copied from the first; the train step on half the columns,
  its mean over those).
- ``altered``: an answer altered where it is produced (each batch's rows
  shifted by one; the reported loss 0.1% off; every third action
  changed).
- ``scaled``: every row of the encoder scaled alike, as an average
  pool's divisor off by one (49 / 48) would, which no angle between
  rows sees.
"""

import torch

from pvr_habitat_tpu_torch.models.registry import int8_serving_fns


def int8(net, ctx):
    q = int8_serving_fns(net.embedding_name)
    params = q.quantize_params(net.params)
    route = net.fused if net.fused in q.fused_routes else "off"
    scales = {}

    def forward(frames):
        with torch.inference_mode():
            x = net.handle.preprocess(frames, out_dtype=torch.bfloat16)
            if not scales:
                _, found = q.apply(params, x, None, fused=route)
                scales.update({k: float(v) for k, v in found.items()})
            out, _ = q.apply(params, x, scales, fused=route)
            return out.reshape(out.shape[0], -1).float()

    net._forward = forward
    return net


def _encoder(fault):
    def hook(net, ctx):
        forward = net._forward
        last = []

        def broken(frames):
            out = forward(frames)
            if fault == "stale":
                prev = last[0] if last else out
                last[:] = [out]
                return prev
            if fault == "half_batch":
                half = out.shape[0] // 2
                return torch.cat([out[:out.shape[0] - half], out[:half]])
            if fault == "scaled":
                return out * (49 / 48)
            return torch.roll(out, 1, dims=0)

        net._forward = broken
        return net
    return hook


def _train_step(fault):
    def hook(step, ctx):
        def broken(state, batch):
            if fault == "half_batch":
                half = batch["action"].shape[1] // 2
                return step(state, {k: v[:, :half] for k, v in batch.items()})
            new_state, metrics = step(state, batch)
            if fault == "stale":
                return state, metrics
            return new_state, dict(metrics, loss=metrics["loss"] * 1.001)
        return broken
    return hook


def _policy(fault):
    def hook(runner, ctx):
        apply_fn, calls = runner.apply_fn, [0]

        def broken(params, stats, inputs, core_state, **kwargs):
            outputs, state, new_stats = apply_fn(params, stats, inputs,
                                                 core_state, **kwargs)
            calls[0] += 1
            if fault == "stale":
                return outputs, core_state, new_stats
            if calls[0] % 3 == 0:
                outputs = dict(outputs, action=(outputs["action"] + 1) % 3)
            return outputs, state, new_stats

        runner.apply_fn = broken
        return runner
    return hook


FAULTS = ("stale", "half_batch", "altered", "scaled")


def hooks(driver, variant):
    """The hooks of ``variant`` (``int8`` or a fault) for a driver's run;
    {} where the driver cannot have it."""
    if variant == "int8":
        return {"encoder": int8} if driver == "embed" else {}
    if driver == "embed" or (driver == "eval" and variant == "scaled"):
        return {"encoder": _encoder(variant)}
    if variant == "scaled":              # the train cell has no encoder
        return {}
    if driver == "train":
        return {"train_step": _train_step(variant)}
    if variant == "half_batch":          # one env: no batch to halve
        return {}
    return {"policy": _policy(variant)}
