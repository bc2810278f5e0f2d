"""Tracing/profiling (counterpart of ``pvr_habitat_tpu/utils/profiling.py``;
the reference has none — tqdm only).

- ``trace(dir)``: a ``torch.profiler`` trace of the block, CPU and CUDA
  activity, written as a Chrome/Perfetto JSON file into ``dir``.
- ``annotate(name)``: a named range in that trace for a host phase.
- ``StepTimer``: cheap rolling step-time/throughput stats printed at an
  interval, usable inside the training loop.  It reads the host clock
  only: without a device sync in the window it measures what was
  enqueued, so callers read it where the loop syncs anyway.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name):
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, items_per_step=1, report_every=100, label="step"):
        self.items = items_per_step
        self.every = report_every
        self.label = label
        self.count = 0
        self._t0 = time.perf_counter()

    def tick(self, printer=print):
        self.count += 1
        if self.count % self.every == 0:
            now = time.perf_counter()
            dt = (now - self._t0) / self.every
            printer(f"   {self.label}: {dt * 1000:.2f} ms/iter, "
                    f"{self.items / dt:.0f} items/s")
            self._t0 = now

