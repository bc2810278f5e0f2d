"""Host ms to enqueue one batch: ``EmbeddingNet._forward`` (preprocess
and encoder launches) on the host clock, over the whole window."""

from port_bench.readings import host_mean_ms


def read(reading, ctx):
    return host_mean_ms(reading, "dispatch")
