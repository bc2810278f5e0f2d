"""The benchmark's readers of the program's spans
(``port_bench/program_spans.py`` and its ``metrics/*.py``): attribution
on made-up tuples, and a traced run of each cell at a tiny size on the
CPU in which every reader of the spans gives a number or None."""

import time

import pytest

from port_bench import harness, program_spans
from port_bench.program_spans import Call, SpanT, attribute
from port_bench.run import reader, run_cell
from port_bench.tests.conftest import SEED, TINY

MAIN, STAGER, OTHER = 11, 12, 13


def _span(i, name, thread, start, end, parent=None):
    return SpanT(i, name, thread, start, end, parent)


def test_kernels_inside_and_outside_a_span():
    spans = [_span(1, "a", MAIN, 10.0, 20.0)]
    calls = [Call(MAIN, 12.0, 100, "cudaLaunchKernel"),
             Call(MAIN, 25.0, 101, "cudaLaunchKernel"),
             Call(MAIN, 5.0, 102, "cudaLaunchKernel")]
    kernels = {100: [2e-6], 101: [3e-6], 102: [4e-6]}
    rows = attribute(spans, calls, kernels, 100.0)
    assert rows["a"]["calls"] == 1
    assert rows["a"]["launches"] == 1
    assert rows["a"]["device_s"] == pytest.approx(2e-6)
    assert rows["a"]["host_s"] == pytest.approx(10e-6)
    assert rows["a"]["syncs"] == 0


def test_nesting_counts_in_both_and_self_time():
    spans = [_span(2, "inner", MAIN, 12.0, 16.0, parent=1),
             _span(1, "outer", MAIN, 10.0, 20.0)]
    calls = [Call(MAIN, 13.0, 1, "cudaLaunchKernel"),
             Call(MAIN, 18.0, 2, "cudaLaunchKernel"),
             Call(MAIN, 14.0, 3, "cudaStreamSynchronize")]
    kernels = {1: [1e-6], 2: [2e-6]}
    rows = attribute(spans, calls, kernels, 100.0)
    assert rows["inner"]["launches"] == 1 and rows["outer"]["launches"] == 2
    assert rows["outer"]["device_s"] == pytest.approx(3e-6)
    assert rows["inner"]["syncs"] == rows["outer"]["syncs"] == 1
    assert rows["outer"]["host_s"] == pytest.approx(6e-6)
    assert rows["inner"]["host_s"] == pytest.approx(4e-6)


def test_a_launch_counts_without_its_kernel_record():
    """A profiler session can lose its first kernel records; the launch
    call still counts, with no device time."""
    spans = [_span(1, "a", MAIN, 0.0, 20.0)]
    calls = [Call(MAIN, 1.0, 1, "cudaLaunchKernel"),
             Call(MAIN, 2.0, 2, "cuLaunchKernelEx"),
             Call(MAIN, 3.0, 3, "cudaMemcpyAsync"),
             Call(MAIN, 4.0, 4, "cudaStreamIsCapturing")]
    rows = attribute(spans, calls, {2: [5e-6]}, 100.0)
    assert rows["a"]["launches"] == 2
    assert rows["a"]["device_s"] == pytest.approx(5e-6)


def test_a_call_on_another_thread():
    spans = [_span(1, "stage", STAGER, 10.0, 20.0),
             _span(2, "dispatch", MAIN, 10.0, 20.0)]
    calls = [Call(STAGER, 15.0, 1, "cudaStreamSynchronize"),
             Call(STAGER, 16.0, 2, "cudaMemcpy"),
             Call(OTHER, 17.0, 3, "cudaLaunchKernel")]
    rows = attribute(spans, calls, {3: [1e-6]}, 100.0)
    assert rows["stage"]["syncs"] == 2 and rows["dispatch"]["syncs"] == 0
    assert rows["dispatch"]["launches"] == 0
    assert rows["dispatch"]["launches_any_thread"] == 1
    assert rows["stage"]["launches_any_thread"] == 1


def test_spans_cut_by_the_slice_are_left_out():
    spans = [_span(1, "a", MAIN, -5.0, 4.0), _span(2, "a", MAIN, 10.0, 20.0),
             _span(3, "b", MAIN, 90.0, 120.0)]
    calls = [Call(MAIN, 1.0, 1, "cudaLaunchKernel"),
             Call(MAIN, 95.0, 2, "cudaLaunchKernel")]
    rows = attribute(spans, calls, {1: [1e-6], 2: [1e-6]}, 100.0)
    assert rows["a"]["calls"] == 1 and rows["a"]["launches"] == 0
    assert "b" not in rows


def test_blocking_calls():
    assert program_spans.blocking("cudaStreamSynchronize")
    assert program_spans.blocking("cudaMemcpy")
    assert program_spans.blocking("cudaMemcpy2D")
    assert not program_spans.blocking("cudaMemcpyAsync")
    assert not program_spans.blocking("cudaLaunchKernel")


SPAN_METRICS = [m["name"] for m in harness.benchmark()["per_layer"]
                if m["source"] == "program_span"
                and m["name"].split(".")[0] in (
                    "encoder_device_ms", "host_syncs", "stage_wait_ms",
                    "forward_launches", "lstm_launches", "backward_launches",
                    "update_launches", "render_ms")]


def test_ten_readers_of_the_spans():
    assert len(SPAN_METRICS) == 10


@pytest.mark.parametrize("cell", list(TINY))
def test_traced_cell_reads(cell):
    result = run_cell(cell, SEED, 0.2, True, "cpu",
                      t_start=time.perf_counter(), overrides=TINY[cell])
    ctx = result["ctx"]
    cells = {m["name"]: m["workloads"]
             for m in harness.benchmark()["per_layer"]}
    read = 0
    for name in SPAN_METRICS:
        value = reader(name)(result["reading"], ctx)
        assert value is None or value >= 0.0, name
        if cell in cells[name]:
            assert isinstance(value, float), name
            read += 1
    assert read == sum(cell in cells[n] for n in SPAN_METRICS) > 0


def test_a_reused_thread_id_names_the_thread_alive_then():
    """Two stager threads one after the other share a ``pthread_self()``;
    the profiler names both by it, and each call goes to the thread whose
    spans surround it."""
    from pvr_habitat_tpu_torch.utils.profiling import Span

    ident = 2 ** 40 + 7
    recorded = [Span(1, "stage", 201, ident, 0, 0, None, {}),
                Span(2, "stage", 202, ident, 0, 0, None, {}),
                Span(3, "dispatch", MAIN, 5, 0, 0, None, {})]
    spans = [_span(1, "stage", 201, 10.0, 20.0),
             _span(2, "stage", 202, 50.0, 60.0),
             _span(3, "dispatch", MAIN, 10.0, 60.0)]
    owner = program_spans._Owners(recorded, spans)
    key = program_spans._int32(ident)
    assert owner(key, 15.0) == 201 and owner(key, 55.0) == 202
    assert owner(key, 21.0) == 201 and owner(key, 49.0) == 202
    assert owner(MAIN, 30.0) == MAIN
    assert owner(999, 30.0) == 999        # a thread with no spans
