"""What the per-layer readers (``metrics/<name>.py``) share.

A reader gets the traced run's ``reading`` and the run's context, and
returns a number or None where it finds nothing to read: never 0 for a
share of a roofline or a peak.  ``reading`` holds the host spans and the
wall seconds an item (``item_s``; a chunk, a step) over the window less
the profiled slices, and from the slices (``items`` items each) the
device's busy seconds, the device seconds inside each range and the
shapes of the kernel calls.
"""

import statistics

from port_bench import costs


def host_mean_ms(reading, span):
    times = reading.host.get(span)
    return statistics.fmean(times) * 1e3 if times else None


def range_ms_per_call(reading, name):
    """Device ms of the kernels launched inside one ``name`` range of the
    profiled slice, on average."""
    seconds, count = reading.prof.ranges.get(name, (0.0, 0))
    return seconds / count * 1e3 if seconds > 0 else None


def busy_ms_per_item(reading):
    busy = reading.prof.busy_s
    return busy / reading.items * 1e3 if busy > 0 else None


def idle_pct(reading):
    """1 - the device's busy seconds an item (the device-only slice) over
    the wall seconds an item outside the slices: the profiler's own
    host cost, a callback a launch, stays out of the share."""
    busy = reading.prof.busy_s
    if not busy or not reading.item_s:
        return None
    return 100.0 * (1.0 - busy / reading.items / reading.item_s)


def roofline_pct(reading, kernel, dtype):
    """Sum of the least times of the kernel's calls in the slice (from
    their shapes) over the device time inside their ranges."""
    calls = [c for c in reading.calls.get(kernel, []) if c["dtype"] == dtype]
    seconds, count = reading.prof.ranges.get(kernel, (0.0, 0))
    if not calls or seconds <= 0 or count != len(calls):
        return None
    if kernel == "fused_bottleneck":
        bound = sum(costs.bound_s(*costs.block_cost(
            c["n"], c["h"], c["stride"], c["cin"], c["p"], c["cout"],
            c["ds"], c["itemsize"]), dtype) for c in calls)
    else:
        bound = sum(costs.bound_s(*costs.attention_cost(
            c["n"], c["h"], c["l"], c["d"], c["itemsize"]), dtype)
            for c in calls)
    return 100.0 * bound / seconds


def mfu_pct(flop_per_frame, reading, dtype):
    """FLOP a frame times the frames a second outside the profiled
    slices, over the peak."""
    if not reading.item_s:
        return None
    return 100.0 * flop_per_frame * reading.frames_per_item \
        / reading.item_s / costs.PEAK_FLOP_PER_S[dtype]
