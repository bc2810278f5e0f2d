"""What every cell's run shares: finding its files by name, the run's
context, host spans and kernel-call records for the traced run, the
profiled slice of the window, and the sample of answers kept for the
check.

A cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
which names the driver, ``drivers/<driver>.py``), the precision it runs
in and the limits of its check.  ``BENCHMARK.json`` at the checkout's
root says which metrics the cell reports and in what unit.
"""

import contextlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(kind, name):
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    with open(path) as handle:
        return json.load(handle)


def benchmark():
    with open(ROOT / "BENCHMARK.json") as handle:
        return json.load(handle)


def cell_files(cell_name):
    """(cell, config, traffic) of a cell, by name."""
    cell = load("workloads", cell_name)
    return cell, load("configs", cell["config"]), load("traffic",
                                                       cell["traffic"])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-clock spans of the traced run, each also a profiler range
    (``pb.<name>``), and the shapes of kernel calls made while the
    profiled slice records.  The host times leave the profiled slice out,
    where the profiler slows the host."""

    def __init__(self):
        self.host = {}
        self.calls = {}
        self.recording = False       # in a profiled slice
        self.recording_calls = False  # in the fully traced slice

    @contextlib.contextmanager
    def span(self, name):
        with torch.autograd.profiler.record_function(f"pb.{name}"):
            start = time.perf_counter()
            try:
                yield
            finally:
                if not self.recording:
                    self.host.setdefault(name, []).append(
                        time.perf_counter() - start)

    def record_call(self, name, shape):
        if self.recording_calls:
            self.calls.setdefault(name, []).append(shape)

    def wrap(self, name, fn, shape_of=None):
        """``fn`` inside a ``pb.<name>`` range; ``shape_of(*args,
        **kwargs)`` gives what a reader needs of each call in the slice."""
        def wrapped(*args, **kwargs):
            if shape_of is not None:
                self.record_call(name, shape_of(*args, **kwargs))
            with torch.autograd.profiler.record_function(f"pb.{name}"):
                return fn(*args, **kwargs)
        return wrapped


@contextlib.contextmanager
def patched(obj, attr, value):
    """``obj.attr = value`` for the duration of the block."""
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


class ProfileSlice:
    """``torch.profiler`` over ``count`` items of the window from item
    ``first``, synchronised at both ends, kept in memory.

    Two slices run back to back.  The first traces the device alone
    (kernels, copies and the runtime calls that launch them), which
    slows the host little: its busy and wall seconds give the device's
    idle share and its operations the breakdown.  The second also
    records the host's operations and the benchmark's ``pb.*`` ranges,
    which slows a host-bound loop several-fold: it gives the device time
    inside each range and what the host was doing in each idle gap."""

    def __init__(self, first, count, device, spans):
        self.first, self.count = first, count
        self.device, self.spans = device, spans
        self.light = self.full = None  # the two profilers
        self.light_s = None             # the device-only slice's wall
        self.overhead_s = 0.0           # both, start and stop included
        self.done = False

    def _start(self, host):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CUDA] if self.device.type == "cuda" \
            else []
        if host or not activities:
            activities.append(ProfilerActivity.CPU)
        self._entered = time.perf_counter()
        sync(self.device)
        prof = profile(activities=activities)
        prof.start()
        if host:
            self._range = torch.autograd.profiler.record_function("pb.window")
            self._range.__enter__()
        self.spans.recording = True
        self.spans.recording_calls = host
        self._t0 = time.perf_counter()
        return prof

    def _stop(self, prof, host):
        sync(self.device)
        wall = time.perf_counter() - self._t0
        self.spans.recording = self.spans.recording_calls = False
        if host:
            self._range.__exit__(None, None, None)
        prof.stop()
        self.overhead_s += time.perf_counter() - self._entered
        return wall

    def before(self, k):
        if k == self.first:
            self.light = self._start(host=False)
        elif k == self.first + self.count:
            self.full = self._start(host=True)

    def after(self, k):
        if k == self.first + self.count - 1:
            self.light_s = self._stop(self.light, host=False)
        elif k == self.first + 2 * self.count - 1:
            self._stop(self.full, host=True)
            self.done = True

    def items(self):
        """Items in each of the two slices."""
        return self.count

    def item_s(self, items, elapsed):
        """Wall seconds an item over the window less the profiled slices,
        their profilers' start and stop included; None if nothing is
        left."""
        rest = items - 2 * self.count
        if rest <= 0 or elapsed <= self.overhead_s:
            return None
        return (elapsed - self.overhead_s) / rest

    def reading(self, top=10):
        """The slices' numbers: ``busy_s`` and ``window_s`` of the device
        slice, the device seconds inside each ``pb.*`` range of the full
        slice, and the breakdown."""
        from torch.autograd import DeviceType

        device = _device_intervals(self.light.events(), DeviceType)
        merged = _merge(device)
        ops = {}
        for start, end, name in device:
            ops[name] = ops.get(name, 0.0) + (end - start) * 1e-6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        ranges, gaps = _ranges_and_gaps(self.full.events(), DeviceType)
        idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return SimpleNamespace(
            busy_s=sum(e - s for s, e in merged) * 1e-6,
            window_s=self.light_s, ranges=ranges,
            breakdown={"device_ops": [[n[:160], v] for n, v in device_ops],
                       "idle_gaps": [[n, v] for n, v in idle_gaps]})


def _device_intervals(events, DeviceType):
    # (the device's copies of the pb.* ranges are not device work)
    return sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("pb.")), key=lambda x: x[0])


def _merge(intervals):
    merged = []
    for start, end, _ in intervals:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _ranges_and_gaps(events, DeviceType):
    """Device seconds of the kernels launched inside each ``pb.*`` range,
    with the number of ranges (a launch is the host's runtime call of the
    same correlation id; nested ranges each count it; copies are left
    out, as the pipeline's other threads issue them), and the device's
    idle gaps by the innermost range the host was in."""
    device = _device_intervals(events, DeviceType)
    launches = {e.id: e for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith("cu")}
    spans, window = [], None
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("pb."):
            if e.name == "pb.window":
                window = (e.time_range.start, e.time_range.end)
            else:
                spans.append((e.time_range.start, e.time_range.end,
                              e.name[3:]))
    starts = np.array([s[0] for s in spans], np.float64)
    ends = np.array([s[1] for s in spans], np.float64)
    names = [s[2] for s in spans]
    ranges = {name: [0.0, names.count(name)] for name in set(names)}
    for kernel in events:
        if kernel.device_type != DeviceType.CUDA or \
                kernel.name.startswith(("pb.", "Memcpy", "Memset")):
            continue
        launch = launches.get(kernel.id)
        if launch is None:
            continue
        t = launch.time_range.start
        inside = np.flatnonzero((starts <= t) & (t <= ends))
        for name in {names[i] for i in inside}:
            ranges[name][0] += (kernel.time_range.end
                                - kernel.time_range.start) * 1e-6
    gaps = {}
    if window is not None:
        lengths = ends - starts
        edges = [window[0]] + [x for iv in _merge(device) for x in iv] \
            + [window[1]]
        for start, end in zip(edges[0::2], edges[1::2]):
            start, end = max(start, window[0]), min(end, window[1])
            if end <= start:
                continue
            mid = 0.5 * (start + end)
            inside = np.flatnonzero((starts <= mid) & (mid <= ends))
            label = (names[inside[np.argmin(lengths[inside])]]
                     if inside.size else "outside the benchmark's spans")
            gaps[label] = gaps.get(label, 0.0) + (end - start) * 1e-6
    return {k: tuple(v) for k, v in ranges.items()}, gaps


class Reservoir:
    """A uniform sample of fixed size, drawn from ``seed``, of every row
    the window produced (Algorithm R), with the key of each."""

    def __init__(self, size, seed):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.keys = np.zeros(size, np.int64)
        self.rows = None

    def add(self, rows, keys):
        n = len(rows)
        if self.rows is None:
            self.rows = np.zeros((self.size,) + rows.shape[1:], rows.dtype)
        fill = min(max(self.size - self.seen, 0), n)
        self.rows[self.seen:self.seen + fill] = rows[:fill]
        self.keys[self.seen:self.seen + fill] = keys[:fill]
        rest = np.arange(fill, n)
        slot = self.rng.integers(0, self.seen + rest + 1)
        take = slot < self.size
        slot, rest = slot[take], rest[take]
        # a slot drawn twice keeps the later row, as one at a time would
        _, last = np.unique(slot[::-1], return_index=True)
        keep = len(slot) - 1 - last
        self.rows[slot[keep]] = rows[rest[keep]]
        self.keys[slot[keep]] = keys[rest[keep]]
        self.seen += n

    def sample(self):
        k = min(self.seen, self.size)
        return self.keys[:k], self.rows[:k]


def rel_err_rows(prog, ref):
    """Per row ||prog - ref|| / ||ref||, float64 on the host."""
    prog = torch.as_tensor(prog).double().cpu()
    ref = torch.as_tensor(ref).double().cpu()
    return (torch.linalg.norm(prog - ref, dim=-1)
            / torch.linalg.norm(ref, dim=-1).clamp_min(1e-30))


class Context:
    """One run of one cell: its files, seed, window length, device, the
    spans of a traced run, the control's or a fault's hooks, and what
    the driver reports back."""

    def __init__(self, cell_name, seed, seconds, trace, device, t_start,
                 hooks=None, overrides=None):
        self.cell, self.config, self.traffic = cell_files(cell_name)
        for key, value in (overrides or {}).items():
            self.traffic[key] = value
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.hooks = hooks or {}
        self.spans = Spans() if trace else None
        self.setup_s = None
        self.slice = None

    def hook(self, point, obj):
        """``obj`` as the control or a planted fault leaves it; the
        benchmark's own runs set no hook."""
        fn = self.hooks.get(point)
        return obj if fn is None else fn(obj, self)

    def setup_done(self):
        sync(self.device)
        self.setup_s = time.perf_counter() - self.t_start
        return self.setup_s

    def profile_slice(self, first, count):
        if self.trace:
            self.slice = ProfileSlice(first, count, self.device, self.spans)
        return self.slice

    def window_done(self, elapsed):
        """The window closes once ``seconds`` have passed and, in a traced
        run, the profiled slice has ended."""
        return elapsed >= self.seconds and (self.slice is None
                                            or self.slice.done)

    def memory_peak(self):
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))
