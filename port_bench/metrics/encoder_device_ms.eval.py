"""Device ms an eval step of the kernels launched inside the program's
``embed.encoder`` span at batch 1 (``models/embedding_net.py::apply``)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["embed.encoder"], "device_s",
                             "embed.encoder", 1e3)
