"""Device ms of the preprocess (``ops/image.py::Preprocess``) per
batch, inside ranges around the handle's ``preprocess`` call."""

from port_bench.readings import range_ms_per_call


def read(reading, ctx):
    return range_ms_per_call(reading, "preprocess")
