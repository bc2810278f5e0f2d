"""Kernels a train step launched inside ``train.clip`` and
``train.optimizer`` (the global-norm clip, RMSprop's update and its
application, ``train/bc_step.py::step_body``)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["train.clip", "train.optimizer"],
                             "launches", "train.optimizer")
