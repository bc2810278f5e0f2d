"""Kernels a train step launched inside the forward LSTM unroll
(``policy.lstm``, ``ops/lstm.py::lstm_scan``)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["policy.lstm"], "launches",
                             "train.forward")
