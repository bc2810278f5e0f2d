"""Host ms of the wrapper env's encoder call at batch 1
(``EmbeddingNet.__call__``, which returns numpy and so waits for the
device)."""

from port_bench.readings import host_mean_ms


def read(reading, ctx):
    return host_mean_ms(reading, "encoder")
