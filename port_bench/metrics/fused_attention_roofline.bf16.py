"""The bf16 attention cores' share of their roofline: the sum of each
call's least time (``costs.attention_cost``, the bf16 peak) over the
device time inside ranges around ``ops/cuda/attention.py::fused_attention``."""

from port_bench.readings import roofline_pct


def read(reading, ctx):
    return roofline_pct(reading, "fused_attention", "bfloat16")
