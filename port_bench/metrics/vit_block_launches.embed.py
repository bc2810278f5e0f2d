"""Kernel launches inside the program's ``vit.attn`` and ``vit.mlp``
spans (``models/vit.py::timm_block``) a batch, over the configuration's
``depth``: what one ViT block launches."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["vit.attn", "vit.mlp"], "launches",
                             "embed.encoder",
                             1.0 / ctx.config["encoder"]["depth"])
