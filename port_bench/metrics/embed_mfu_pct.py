"""The encoder's FLOP per frame (from the configuration's shapes)
times the traced run's frames/s, over the peak of the cell's
precision."""

from port_bench import costs
from port_bench.readings import mfu_pct


def read(reading, ctx):
    return mfu_pct(costs.encoder_flop_per_frame(ctx.config["encoder"]),
                   reading, ctx.cell["precision"])
