"""Host ms a step of the trainer's data feed: ``sample_with_minimum_
distance`` and ``gather_unrolls`` (``data/sampler.py``), host clock, over
the whole window."""

from port_bench.readings import host_mean_ms


def read(reading, ctx):
    return host_mean_ms(reading, "sample")
