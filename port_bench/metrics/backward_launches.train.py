"""Kernels a train step launched inside ``train.backward``
(``torch.autograd.grad`` in ``train/bc_step.py::step_body``), from any
thread: the autograd engine launches a device's backward from a thread
of its own while the caller waits."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["train.backward"], "launches_any_thread",
                             "train.backward")
