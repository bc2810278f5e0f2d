"""The share of train steps replayed from a captured CUDA graph: calls
of ``train.graph`` over calls of ``train.step`` (``train/bc_step.py::
make_train_step``), in the profiled slice."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["train.graph"], "calls", "train.step")
