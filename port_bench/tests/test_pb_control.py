"""The controls on the card, at a size a test run holds: each fails one
of its cell's numbers, where sound runs of the program pass them all.

The control of a bf16 cell is the program's own int8 path; of a float32
cell, the reference in TF32 in the program's place (the CPU has no
TF32, so these run on the card only)."""

import time

import pytest

from port_bench import faults, harness
from port_bench.run import run_cell

SMALL = {
    "embed.resnet50.b256": dict(pool_frames=1024, chunk_frames=512),
    "embed.mae_base.b256": dict(pool_frames=1024, chunk_frames=512),
    "train.resnet50.b32t100": dict(trajectories=600),
    "eval.resnet50.k1": dict(warm_steps=5, profile_from=1, profile_steps=5),
}


def _run(cell, hooks=None, seed=2 ** 31 + 23):
    return run_cell(cell, seed, 2.0, False, "cuda",
                    t_start=time.perf_counter(), hooks=hooks,
                    overrides=SMALL[cell])


def _failed(numbers, checks):
    """The compared numbers over their limits (a result's ``checks``)."""
    return {k: numbers[k] for k, (_, limit) in checks.items()
            if not numbers[k] <= limit}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_where_the_program_passes(card, cell):
    result = _run(cell)
    assert not _failed({k: v for k, (v, _) in result["checks"].items()},
                       result["checks"]), result["checks"]
    driver = harness.cell_files(cell)[2]["driver"]
    if driver == "embed":
        control = _run(cell, faults.hooks(driver, "int8"))
        numbers = {k: v for k, (v, _) in control["checks"].items()}
    else:
        numbers = result["control"]()
    assert _failed(numbers, result["checks"]), numbers
