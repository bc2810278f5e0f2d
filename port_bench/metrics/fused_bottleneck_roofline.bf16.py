"""The bf16 bottleneck blocks' share of their roofline: the sum of
each call's least time (``costs.block_cost`` of its shapes, the bf16
peak) over the device time inside ranges around the port's block
wrapper (``ops/cuda/fused_bottleneck.py::fused_bottleneck``)."""

from port_bench.readings import roofline_pct


def read(reading, ctx):
    return roofline_pct(reading, "fused_bottleneck", "bfloat16")
