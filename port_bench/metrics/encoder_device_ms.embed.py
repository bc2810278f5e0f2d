"""Device ms a batch of the kernels launched inside the program's
``embed.encoder`` span (``models/embedding_net.py::apply``, the encoder's
forward after the preprocess)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["embed.encoder"], "device_s",
                             "embed.encoder", 1e3)
