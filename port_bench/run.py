"""One run of one benchmark cell of ``pvr_habitat_tpu_torch`` on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed, the program built and warmed
up), a window of ``--seconds``, then the check against the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, as
``BENCHMARK.json`` lists them), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error.  Without CUDA, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it exits nonzero and prints no result.  The process
keeps one thread in each numerical library's pool.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One thread in each numerical library's pool, set before numpy and torch
# load: idle pool threads spinning beside the dispatching threads made
# the host-bound cells' rates differ by a fifth from process to process.
THREAD_POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
if __name__ == "__main__":
    os.environ.update({key: "1" for key in THREAD_POOLS})

from port_bench import harness  # noqa: E402

# The program's build and kernel caches live at fixed paths inside the
# checkout, so that only a checkout's first run builds.
CACHES = {"TORCH_EXTENSIONS_DIR": harness.ROOT / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": harness.ROOT / "build" / "triton"}
FORBIDDEN = ("jax", "jaxlib", "flax", "pvr_habitat_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is JAX,
    Flax or the JAX package; ``pvr_habitat_tpu_torch`` is not one."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def cell_entry(bench, cell_name):
    for entry in bench["workloads"]:
        if entry["name"] == cell_name:
            return entry
    raise SystemExit(f"unknown workload {cell_name!r}")


def applies(metric, cell_name):
    return cell_name in metric.get("workloads", [cell_name])


def reader(name):
    """``metrics/<name>.py``'s ``read``."""
    path = harness.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_cell(cell_name, seed, seconds, trace, device, t_start=None,
             hooks=None, overrides=None):
    """Set-up, window and check of one cell on ``device``; the driver's
    result with ``setup_s`` and the ``ctx`` it ran in."""
    ctx = harness.Context(cell_name, seed, seconds, trace, device,
                          T_START if t_start is None else t_start,
                          hooks=hooks, overrides=overrides)
    driver = importlib.import_module(
        f"port_bench.drivers.{ctx.traffic['driver']}")
    result = driver.run(ctx)
    result["setup_s"] = ctx.setup_s
    result["ctx"] = ctx
    return result


def result_line(result, bench, cell_name, trace, device_info):
    """The run's result as the JSON object the last line carries."""
    ctx = result["ctx"]
    metrics = {}
    if not trace:
        values = dict(result["e2e"], setup_s=result["setup_s"])
        for m in bench["end_to_end"]:
            if applies(m, cell_name) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not applies(m, cell_name):
                continue
            value = reader(m["name"])(result["reading"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=result["memory_peak_bytes"])
    line = {"correct": None, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": device}
    if trace:
        prof = result["reading"].prof
        device.update(busy_s=prof.busy_s, window_s=prof.window_s)
        line["breakdown"] = prof.breakdown
    checks = {name: {"value": value, "limit": limit}
              for name, (value, limit) in result["checks"].items()}
    line["correct"] = result["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    line["checks"] = checks
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)

    import torch

    bench = harness.benchmark()
    chips = cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips}
    line = result_line(result, bench, args.workload, bool(args.trace),
                       device_info)
    print(json.dumps({"info": result["info"], "setup_s": result["setup_s"]}),
          file=sys.stderr)
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
