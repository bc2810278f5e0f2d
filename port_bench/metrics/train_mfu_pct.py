"""The policy's FLOP a frame, forward and backward (3 x the forward),
times the traced run's training frames/s, over the float32 peak (the
trainer runs float32 with TF32 off)."""

from port_bench import costs
from port_bench.readings import mfu_pct


def read(reading, ctx):
    flop = 3 * costs.policy_flop_per_frame(ctx.config["policy"])
    return mfu_pct(flop, reading, ctx.cell["precision"])
