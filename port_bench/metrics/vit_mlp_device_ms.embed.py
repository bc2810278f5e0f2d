"""Device ms a batch of the kernels launched inside the program's
``vit.mlp`` spans (``models/vit.py::timm_block``'s MLP half: norm2, fc1,
GELU, fc2 and the residual add), summed over the blocks."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["vit.mlp"], "device_s",
                             "embed.encoder", 1e3)
