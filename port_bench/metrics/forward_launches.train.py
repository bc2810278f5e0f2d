"""Kernels a train step launched inside ``train.forward``
(``train/bc_step.py::step_body``: the policy, its LSTM unroll included,
and the loss)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["train.forward"], "launches",
                             "train.forward")
