"""The program's own spans (``pvr_habitat_tpu_torch/utils/profiling.py``)
read against a traced run's profiled slice: by span name, the calls, the
host seconds (self time: less the child spans), the kernels launched
inside and their device seconds, and the runtime calls inside that wait
for the device.

Two halves.  ``tuples`` turns a profiler's events and the program's span
buffer into plain tuples on the profiler's timeline (microseconds);
``attribute`` turns tuples into numbers, and is tested on made-up ones.
A kernel belongs to a span when its runtime launch call ran on the
span's thread inside its interval: the launches are those calls, and
their kernels' device time is matched to them by correlation id.  (The
first kernel records of a profiler session can be missing where their
launch calls are not: up to 6 of 29,000 in the first 4 ms of a slice on
an H100 with torch 2.11.)  A runtime call names its thread by the
profiler's resource id: the OS thread id on a thread the profiler knows,
else ``pthread_self()`` cut to 32 bits, which a span records as
``ident``.  ``launches_any_thread`` counts the launches of every thread
inside the interval (the autograd engine launches a backward's kernels
from a thread of its own).  Spans the slice cut are left out.

The device-only slice is read where its events hold the runtime calls,
as they do on the card; otherwise the fully traced one.  A program
without the spans reads as None, and so does a span it never recorded.
"""

import bisect
from collections import namedtuple

SpanT = namedtuple("SpanT", "id name thread start end parent")
Call = namedtuple("Call", "thread t corr name")

# Runtime calls that return only once the device has done its work.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
FIELDS = ("calls", "host_s", "launches", "device_s", "syncs",
          "launches_any_thread")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel",
            "cudaLaunchCooperativeKernel")


def blocking(name):
    """A runtime call that waits for the device: a synchronize, or a
    ``cudaMemcpy*`` that is not ``Async``."""
    return name in SYNCS or (name.startswith("cudaMemcpy")
                             and "Async" not in name)


def tuples(events, recorded, to_us):
    """(spans, calls, kernels, end) of one slice from its raw profiler
    events (``kineto_results.events()``: the parsed ``events()`` fold a
    runtime call into a same-named one of another thread it overlaps, as
    the device-only slice gives every call one thread number): the
    program's spans and the host's runtime calls on the profiler's
    timeline (``to_us`` of a ``time.time_ns()`` reading), the calls on
    the OS ids of their threads, the device seconds of each correlation
    id's kernels (copies and fills left out), and the last event's end."""
    from torch.autograd import DeviceType

    spans = [SpanT(s.id, s.name, s.thread, to_us(s.start_ns),
                   to_us(s.end_ns), s.parent) for s in recorded]
    owner = _Owners(recorded, spans)
    calls, kernels, end = [], {}, 0.0
    for e in events:
        name, start = e.name(), to_us(e.start_ns())
        end = max(end, to_us(e.end_ns()))
        if e.device_type() == DeviceType.CPU and name.startswith("cu"):
            thread = owner(e.device_resource_id(), start)
            calls.append(Call(thread, start, e.correlation_id(), name))
        elif e.device_type() == DeviceType.CUDA and not name.startswith(
                ("pb.", "Memcpy", "Memset")):
            kernels.setdefault(e.correlation_id(), []).append(
                e.duration_ns() * 1e-9)
    return spans, calls, kernels, end


class _Owners:
    """The OS thread of a runtime call's resource id at a time.  A dead
    thread's ``pthread_self()`` comes back for a later thread, so an id
    may name several threads, each over the interval of its spans."""

    def __init__(self, recorded, spans):
        seen = {}
        for r, s in zip(recorded, spans):
            keys = {r.thread}
            if getattr(r, "ident", None) is not None:
                keys.add(_int32(r.ident))
            for key in keys:
                lo, hi = seen.get((key, r.thread), (s.start, s.end))
                seen[key, r.thread] = (min(lo, s.start), max(hi, s.end))
        self.by_key = {}
        for (key, thread), (lo, hi) in seen.items():
            self.by_key.setdefault(key, []).append((lo, hi, thread))

    def __call__(self, key, t):
        owners = self.by_key.get(key)
        if not owners:
            return key
        return min(owners, key=lambda o: max(o[0] - t, t - o[1], 0.0))[2]


def _int32(ident):
    return (ident + 2 ** 31) % 2 ** 32 - 2 ** 31


class _Prefix:
    """Calls in time order with running sums of what each one adds."""

    def __init__(self, calls, kernels):
        self.t = [c.t for c in calls]
        self.sums = [(0, 0.0, 0)]
        for c in calls:
            n, dev, syncs = self.sums[-1]
            self.sums.append((n + c.name.startswith(LAUNCHES),
                              dev + sum(kernels.get(c.corr, ())),
                              syncs + blocking(c.name)))

    def between(self, start, end):
        lo = bisect.bisect_left(self.t, start)
        hi = bisect.bisect_right(self.t, end)
        return tuple(b - a for a, b in zip(self.sums[lo], self.sums[hi]))


def attribute(spans, calls, kernels, end):
    """By span name, a dict of ``FIELDS`` over the spans that lie wholly
    in the slice ``[0, end]``.  Nested spans each count what lies inside
    them."""
    inside = [s for s in spans if s.start >= 0 and s.end <= end]
    covered = {}
    for s in inside:
        if s.parent is not None:
            covered[s.parent] = covered.get(s.parent, 0.0) + s.end - s.start
    calls = sorted(calls, key=lambda c: c.t)
    everyone = _Prefix(calls, kernels)
    threads = {}
    for c in calls:
        threads.setdefault(c.thread, []).append(c)
    threads = {k: _Prefix(v, kernels) for k, v in threads.items()}
    rows = {}
    for s in inside:
        row = rows.setdefault(s.name, dict.fromkeys(FIELDS, 0))
        row["calls"] += 1
        row["host_s"] += (s.end - s.start - covered.get(s.id, 0.0)) * 1e-6
        if s.thread in threads:
            n, dev, syncs = threads[s.thread].between(s.start, s.end)
            row["launches"] += n
            row["device_s"] += dev
            row["syncs"] += syncs
        row["launches_any_thread"] += everyone.between(s.start, s.end)[0]
    return rows


def _program_spans():
    """The program's ``spans`` and ``profiler_us``, or None where its
    ``profiling`` has none."""
    from pvr_habitat_tpu_torch.utils import profiling

    recorder = getattr(profiling, "spans", None)
    to_us = getattr(profiling, "profiler_us", None)
    if not (callable(recorder) and callable(to_us)):
        return None
    return recorder, to_us


def _raw_events(prof):
    return prof.profiler.kineto_results.events()


def _has_runtime_calls(events):
    from torch.autograd import DeviceType

    return any(e.device_type() == DeviceType.CPU
               and e.name().startswith("cu") for e in events)


def rows(ctx):
    """``attribute`` of the traced run's slice (cached on it), or None."""
    sl = ctx.slice
    if sl is None or sl.light is None or sl.full is None:
        return None
    if not hasattr(sl, "program_rows"):
        sl.program_rows = None
        program = _program_spans()
        if program is not None:
            recorder, to_us = program
            prof = sl.light if _has_runtime_calls(_raw_events(sl.light)) \
                else sl.full
            sl.program_rows = attribute(*tuples(
                _raw_events(prof), recorder(), lambda t: to_us(t, prof)))
    return sl.program_rows


def per(ctx, names, field, per_span, scale=1.0):
    """Sum of ``field`` over the spans ``names``, times ``scale``, over the
    calls of the span ``per_span`` (a batch, a step); None where either
    was not recorded."""
    found = rows(ctx)
    if not found or per_span not in found or \
            not any(n in found for n in names):
        return None
    total = sum(found[n][field] for n in names if n in found)
    return float(total * scale / found[per_span]["calls"])
