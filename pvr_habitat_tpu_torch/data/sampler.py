"""Batch-start sampling and unroll gathering (counterpart of
``pvr_habitat_tpu/data/sampler.py``).

The reference samples ``batch_size`` start indices with pairwise
minimum distance ``unroll_length`` (src/utils_bc.py:17-29) and gathers
``unroll_length`` consecutive steps per start with wraparound modulo the
dataset (main_bc_2.py:188-201).

Start sampling stays on the host on Python's ``random``, so the port
draws the JAX package's (and the reference's) exact stream for the same
seed.  The gather is one ``torch`` index on the device the data lives
on, so a device-resident dataset never bounces through the host.
"""

import random

import numpy as np
import torch

from pvr_habitat_tpu_torch.utils.profiling import span


def _ranks(sample):
    order = sorted(range(len(sample)), key=lambda i: sample[i])
    ranks = [0] * len(sample)
    for rank, idx in enumerate(order):
        ranks[idx] = rank
    return ranks


def sample_with_minimum_distance(n, k, d, rng=random):
    """k start indices in range(n) with pairwise distance >= d (rank
    trick; same algorithm and RNG stream as the reference)."""
    sample = rng.sample(range(n - (k - 1) * (d - 1)), k)
    return [s + (d - 1) * r for s, r in zip(sample, _ranks(sample))]


def unroll_index(starts, unroll_length, n):
    """idx[t, b] = (starts[b] + t) % n, on the device of ``starts`` (a
    tensor) — the same wraparound as np.mod."""
    steps = torch.arange(unroll_length, device=starts.device)
    return (starts.long()[None, :] + steps[:, None]) % n


def gather_unrolls(data, starts, unroll_length):
    """data: dict of tensors keyed obs/action/done, all on one device;
    starts: B host start indices.  Returns a dict of (T, B, ...) tensors
    on that device, inside a ``data.gather`` span."""
    with span("data.gather"):
        first = next(iter(data.values()))
        starts = torch.as_tensor(np.asarray(starts, np.int64)).to(
            first.device)
        idx = unroll_index(starts, unroll_length, first.shape[0])
        return {k: v[idx] for k, v in data.items()}


def dataset_nbytes(data):
    return sum(v.nbytes for v in data.values())


def to_tensors(data, device):
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in data.items()}


def maybe_device_put(data, device, mode="auto", budget_bytes=None):
    """Place the BC dataset (a dict of numpy arrays) on ``device`` when it
    fits (mode='auto': 60% of the card's free memory), always, or never.
    Returns (dict of tensors, on_device); with on_device False the
    tensors stay in host memory and each unroll is gathered there."""
    device = torch.device(device)
    if mode == "never":
        return to_tensors(data, "cpu"), False
    if mode == "auto":
        if budget_bytes is None and device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            budget_bytes = int(0.6 * free)
        if budget_bytes is not None and dataset_nbytes(data) > budget_bytes:
            return to_tensors(data, "cpu"), False
    return to_tensors(data, device), True
