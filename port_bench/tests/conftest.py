"""Shared sizes of the CPU tests: every cell at a tiny size through the
port's ``device="cpu"`` path (full widths, few rows)."""

import time

import pytest

TINY = {
    "embed.resnet50.b256": dict(pool_frames=8, chunk_frames=4, batch=2),
    "embed.mae_base.b256": dict(pool_frames=8, chunk_frames=4, batch=2),
    "train.resnet50.b32t100": dict(batch=4, unroll=6, trajectories=40,
                                   profile_steps=2, window_check=[1, 4]),
    "eval.resnet50.k1": dict(warm_steps=2, profile_from=1,
                             profile_steps=3),
}
SEED = 2 ** 31 + 11          # past 32 signed bits, as the driver's are


@pytest.fixture
def tiny_run():
    from port_bench.run import run_cell

    def go(cell, trace=False, hooks=None, seconds=0.2, seed=SEED):
        return run_cell(cell, seed, seconds, trace, "cpu",
                        t_start=time.perf_counter(), hooks=hooks,
                        overrides=TINY[cell])
    return go


@pytest.fixture
def card():
    """Skips, with the reason, where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.device("cuda")
