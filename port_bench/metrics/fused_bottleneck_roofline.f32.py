"""The f32 bottleneck blocks' share of their roofline at the eval
batch: as the bf16 reader, with the float32 peak."""

from port_bench.readings import roofline_pct


def read(reading, ctx):
    return roofline_pct(reading, "fused_bottleneck", "float32")
