"""Tracing/profiling (counterpart of ``pvr_habitat_tpu/utils/profiling.py``;
the reference has none — tqdm only).

- ``span(name, **attrs)``: a named interval of the program's work at a
  layer boundary.  It records only while a ``torch.profiler`` records;
  otherwise it costs one read of the profiler's enabled flag and returns
  a shared no-op context manager.  While on, each span appends one
  ``Span`` (name, OS thread id, the thread's ``threading.get_ident()``,
  start and end on ``time.time_ns()``, the enclosing span on the same
  thread, attributes) to a bounded buffer in memory.  (The profiler's
  runtime calls carry one of the two thread ids: the OS one on threads it
  knows, the other, cut to 32 bits, on the rest.)  It opens no
  ``record_function``: it records threads the profiler does not (the
  pipeline's stager and fetcher) and adds no event to the profiler's
  own.  An attribute given as a callable is called when the span opens,
  so a shape costs nothing while off.
- ``spans()``: the buffer; ``profiler_us(t_ns, prof)``: a span's time on
  a profiler's timeline, the microseconds of its events' ``time_range``.
- ``trace(dir)``: a ``torch.profiler`` trace of the block, CPU and CUDA
  activity, with the spans recorded in the block, written as a
  Chrome/Perfetto JSON file into ``dir``.
- ``StepTimer``: the training rate between report points, read where the
  loop has waited for the device anyway.
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

Span = collections.namedtuple(
    "Span", "id name thread ident start_ns end_ns parent attrs")

MAX_SPANS = 1 << 18          # the oldest go first once the buffer is full
_buffer = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count()
_local = threading.local()   # the innermost open span's id, per thread
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.attrs = {k: v() if callable(v) else v
                      for k, v in self.attrs.items()}
        self.id = next(_ids)
        self.parent = getattr(_local, "top", None)
        _local.top = self.id
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.top = self.parent
        _buffer.append(Span(self.id, self.name, threading.get_native_id(),
                            threading.get_ident(), self.start, end,
                            self.parent, self.attrs))
        return False


def span(name, **attrs):
    """A context manager around one piece of the program's work; see the
    module docstring."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, attrs)


def spans(since=0):
    """The recorded spans with an id of at least ``since``, in the order
    they closed."""
    return [s for s in list(_buffer) if s.id >= since]


def profiler_us(t_ns, prof):
    """``time.time_ns()`` reading ``t_ns`` on the timeline of the stopped
    ``torch.profiler.profile`` ``prof``: the microseconds since its trace
    began, as its events' ``time_range`` gives them."""
    return (t_ns - prof.profiler.kineto_results.trace_start_ns()) / 1e3


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
    first = next(_ids)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans(first))


def _add_spans(path, recorded):
    """The spans as complete events on their threads in the Chrome trace
    at ``path``, whose timestamps are microseconds from its
    ``baseTimeNanoseconds``."""
    with open(path) as handle:
        doc = json.load(handle)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.attrs}
        for s in recorded)
    with open(path, "w") as handle:
        json.dump(doc, handle, default=str)


class StepTimer:
    """ms a step and items a second over the steps ticked since the last
    ``restart``.  ``report`` belongs where the loop has just waited for
    the device (a metric read to the host), so the time is the steps' own
    and not their enqueue; ``restart`` after the work between report
    points (eval, checkpoints) keeps that work out of the next rate."""

    def __init__(self, items_per_step=1, label="step",
                 clock=time.perf_counter):
        self.items = items_per_step
        self.label = label
        self.clock = clock
        self.restart()

    def restart(self):
        self.count = 0
        self._t0 = self.clock()

    def tick(self):
        self.count += 1

    def report(self, printer=print):
        """Prints and returns the seconds a step since ``restart``; None
        before the first tick."""
        if not self.count:
            return None
        dt = (self.clock() - self._t0) / self.count
        printer(f"   {self.label}: {dt * 1000:.2f} ms/iter, "
                f"{self.items / dt:.0f} items/s")
        return dt
