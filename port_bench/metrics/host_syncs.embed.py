"""Runtime calls a batch that wait for the device (synchronizes, copies
that are not ``Async``), on every thread of the pipeline
(``utils/pipeline.py``): the stager's ``pipeline.stage``, the caller's
``pipeline.wait_stage``, ``pipeline.dispatch`` and ``pipeline.wait_slot``,
the fetcher's ``pipeline.fetch``."""

from port_bench import program_spans

PIPELINE = ["pipeline.stage", "pipeline.wait_stage", "pipeline.dispatch",
            "pipeline.wait_slot", "pipeline.fetch"]


def read(reading, ctx):
    return program_spans.per(ctx, PIPELINE, "syncs", "pipeline.dispatch")
