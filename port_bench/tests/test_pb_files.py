"""Every file of the benchmark parses, is found by name, and
``BENCHMARK.json`` keeps the shape its readers expect."""

import json
import re

import pytest

from port_bench import harness
from port_bench.run import reader

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert "port_bench" in BENCH["paths"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    config = harness.load("configs", entry["name"])
    assert harness.HERE.parent.joinpath(entry["file"]).is_file()
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files(entry):
    cell, config, traffic = harness.cell_files(entry["name"])
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    assert entry["chips"] in (1, 4)
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert isinstance(getattr(harness.torch, cell["precision"]),
                      harness.torch.dtype)
    assert cell["correct"]["limits"]
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_pairs_and_names_unique():
    # no two cells run the same configuration, traffic and precision
    runs = [tuple(harness.load("workloads", w["name"])[k]
                  for k in ("config", "traffic", "precision"))
            for w in BENCH["workloads"]]
    assert len(set(runs)) == len(runs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(reader(metric["name"]))
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_every_reader_is_named():
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_every_cell_reports_enough():
    for cell in (w["name"] for w in BENCH["workloads"]):
        e2e = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_data_files_parse():
    for kind in ("configs", "workloads", "traffic"):
        for path in (harness.HERE / kind).glob("*.json"):
            assert isinstance(json.loads(path.read_text()), dict), path
