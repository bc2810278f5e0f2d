"""Each driver runs a short window on the CPU at a tiny size, through the
port's ``device="cpu"`` path, and gives a well-formed result line; the
check comes out correct on sound runs."""

import json

import pytest

from port_bench import harness
from port_bench.run import result_line

from .conftest import TINY

BENCH = harness.benchmark()
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1}


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", list(TINY))
def test_driver_line(tiny_run, cell, trace):
    result = tiny_run(cell, trace=trace)
    line = json.loads(json.dumps(result_line(result, BENCH, cell, trace,
                                             DEVICE)))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    if trace:
        assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(
            line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["metrics"], "no per-layer metric read"
        names = {m["name"] for m in BENCH["per_layer"]
                 if cell in m["workloads"]}
        assert set(line["metrics"]) <= names
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) == 2
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]


def test_same_seed_same_inputs():
    from port_bench import inputs

    a = inputs.frame_pool(4, 64, 2 ** 31 + 3, harness.torch.device("cpu"))
    b = inputs.frame_pool(4, 64, 2 ** 31 + 3, harness.torch.device("cpu"))
    c = inputs.frame_pool(4, 64, 2 ** 31 + 4, harness.torch.device("cpu"))
    assert (a == b).all() and not (a == c).all()


def test_lengths_are_the_same_multiset():
    from port_bench import inputs

    traffic = harness.load("traffic", "bc_b32t100")
    a = inputs.trajectory_lengths(traffic, 1)
    b = inputs.trajectory_lengths(traffic, 2 ** 33)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.min() == 7 and a.max() == 105


def test_reservoir_is_uniform_and_keyed():
    import numpy as np

    counts = np.zeros(100)
    for seed in range(400):
        r = harness.Reservoir(10, seed)
        for lo in range(0, 100, 25):
            keys = np.arange(lo, lo + 25)
            r.add(keys[:, None].astype(np.float32), keys)
        keys, rows = r.sample()
        assert (rows[:, 0] == keys).all() and len(set(keys)) == 10
        counts[keys] += 1
    assert counts.min() > 20 and counts.max() < 70     # 40 expected
