"""Device ms a batch of the kernels launched inside the program's
``kernel.layer_norm`` spans (``ops/cuda/layer_norm.py``: every LayerNorm
of the ViT encoder, two a block and the final norm)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["kernel.layer_norm"], "device_s",
                             "embed.encoder", 1e3)
