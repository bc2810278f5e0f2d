"""Kernels the host still launches one by one inside ``train.step``
(``train/bc_step.py::make_train_step``), from any thread, a step.  A
graph's replay (``cudaGraphLaunch``) is not a kernel launch here, so on
the graphed path this counts the copies in and out and the lr's fill;
on the eager path, every kernel of the step."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["train.step"], "launches_any_thread",
                             "train.step")
