"""The encoder's FLOP of one frame plus the policy's forward FLOP,
a step, times the traced run's steps/s, over the float32 peak."""

from port_bench import costs
from port_bench.readings import mfu_pct


def read(reading, ctx):
    flop = (costs.encoder_flop_per_frame(ctx.config["encoder"])
            + costs.policy_flop_per_frame(ctx.config["policy"]))
    return mfu_pct(flop, reading, ctx.cell["precision"])
