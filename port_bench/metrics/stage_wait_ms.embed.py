"""Host ms a batch that the pipeline's caller waits for the stager's
upload (``pipeline.wait_stage``, ``utils/pipeline.py``)."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["pipeline.wait_stage"], "host_s",
                             "pipeline.dispatch", 1e3)
