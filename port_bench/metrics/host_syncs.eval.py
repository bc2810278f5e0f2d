"""Runtime calls an eval step that wait for the device, on the
dispatching thread: inside the policy step (``eval.policy``,
``train/evaluate.py::PolicyRunner``), the encoder call (``embed.call``,
``EmbeddingNet.__call__``) and the render (``env.render``)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["eval.policy", "embed.call", "env.render"],
                             "syncs", "eval.policy")
