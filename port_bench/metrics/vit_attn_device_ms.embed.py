"""Device ms a batch of the kernels launched inside the program's
``vit.attn`` spans (``models/vit.py::timm_block``'s attention half:
norm1, the qkv product, the attention core, the projection and the
residual add), summed over the blocks."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["vit.attn"], "device_s",
                             "embed.encoder", 1e3)
