"""The device's idle share: 1 - its busy seconds an item (the union of
every device activity's interval in the device-only profiled slice) over
the wall seconds an item outside the profiled slices."""

from port_bench.readings import idle_pct


def read(reading, ctx):
    return idle_pct(reading)
