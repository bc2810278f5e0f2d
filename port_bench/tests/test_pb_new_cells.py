"""The cells ``embed.mae_huge.b256`` (MAE ViT-H/14, bulk bf16) and
``embed.resnet50.traj_f32`` (one f32 call a trajectory, the
``embed_traj`` driver) at a tiny size on the CPU, as ``test_pb_drivers``
and ``test_pb_faults`` run the others: a well-formed plain and traced
line, correct on sound runs, and not correct under each planted encoder
fault.  ViT-H keeps its full widths and depth here: each of its runs
draws 630 M weights twice and takes about a minute."""

import json
import time

import pytest

from port_bench import faults, harness
from port_bench.run import result_line, run_cell

from .conftest import SEED

BENCH = harness.benchmark()
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1}
HUGE, TRAJ = "embed.mae_huge.b256", "embed.resnet50.traj_f32"
TINY = {
    HUGE: dict(pool_frames=8, chunk_frames=4, batch=2),
    TRAJ: dict(pool_frames=32, trajectories=4, min_length=2, max_length=5,
               profile_trajectories=2),
}
VIT_READERS = {"vit_attn_device_ms.embed", "vit_mlp_device_ms.embed",
               "vit_block_launches.embed"}
# the traj driver plants no encoder fault through ``faults.hooks``
FAULT_HOOKS = {
    HUGE: {fault: faults.hooks("embed", fault) for fault in faults.FAULTS},
    TRAJ: {fault: {"encoder": faults._encoder(fault)}
           for fault in ("stale", "altered", "scaled")},
}


def _run(cell, trace=False, hooks=None, seconds=0.2):
    return run_cell(cell, SEED, seconds, trace, "cpu",
                    t_start=time.perf_counter(), hooks=hooks,
                    overrides=TINY[cell])


def _line(result, cell, trace):
    return json.loads(json.dumps(result_line(result, BENCH, cell, trace,
                                             DEVICE)))


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", list(TINY))
def test_new_cell_line(cell, trace):
    result = _run(cell, trace=trace)
    line = _line(result, cell, trace)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(
            line["device"])
        names = {m["name"] for m in BENCH["per_layer"]
                 if cell in m["workloads"]}
        assert line["metrics"] and set(line["metrics"]) <= names
    else:
        assert set(line["metrics"]) == {"embed_frames_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    if trace and cell == HUGE:
        # the readers of ``vit.attn`` / ``vit.mlp`` find the spans
        assert VIT_READERS <= set(line["metrics"])
    if cell == TRAJ:
        assert result["info"]["trajectories"] >= (5 if trace else 1)


@pytest.mark.parametrize("cell,fault", [(cell, fault) for cell in TINY
                                        for fault in FAULT_HOOKS[cell]])
def test_fault_fails_the_check(cell, fault):
    result = _run(cell, hooks=FAULT_HOOKS[cell][fault], seconds=0.5)
    line = _line(result, cell, False)
    assert line["correct"] is False, line["checks"]
