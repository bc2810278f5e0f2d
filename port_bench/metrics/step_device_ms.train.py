"""Device busy ms a train step (``train/bc_step.py``, ``models/
policy.py``, ``ops/lstm.py``, ``train/optim.py``), over the profiled
steps."""

from port_bench.readings import busy_ms_per_item


def read(reading, ctx):
    return busy_ms_per_item(reading)
