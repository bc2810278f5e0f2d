"""Multi-process bring-up over ``torch.distributed`` (counterpart of
``pvr_habitat_tpu/parallel/multihost.py``).

The model is the JAX package's: every process runs the SAME program and
joins one group (``--coordinator host:port --num_processes N
--process_id i`` on the CLI entry points, through ``session``); each
touches only its slice of the input (``process_slice``), and the slices
come together by an all-gather of ragged rows (``allgather_rows``).  One
process is one device: its card, or the CPU.  The collectives take a
``group`` (default: every rank): the mesh's rows and columns
(``parallel/mesh.py``).  Tensor parallelism's two autograd functions are
here: ``copy_to_shards`` (the input of a row-sharded product: identity,
and in backward the sum over the group of the ranks' shares) and
``gather_columns`` (its output: an all-gather, and in backward the
rank's own columns).

The backend follows the devices, and the choice is printed.  Before the
group forms, every rank posts its host name and card count to the
coordinator's store; a rank's local rank is its place among the ranks of
its host, and it takes card ``local rank % cards``.
- ``nccl`` when every rank has a card of its own: on each host, no more
  ranks than cards;
- ``gloo`` on the CPU, and when ranks share a card, which NCCL refuses.
  Gloo's collectives here run on host tensors: a CUDA tensor is copied to
  the host for the collective and back.
"""

import collections
import contextlib
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=10)


def choose_backend(device, layout, process_id):
    """(backend, local rank, why) for rank ``process_id`` of ranks that
    would run on ``device``; ``layout[i]`` is rank i's (host name, cards
    on that host)."""
    host = layout[process_id][0]
    local_rank = [h for h, _ in layout[:process_id]].count(host)
    if torch.device(device).type != "cuda":
        return "gloo", local_rank, "the ranks run on the CPU"
    ranks = collections.Counter(h for h, _ in layout)
    cards = dict(layout)
    for h in ranks:
        if ranks[h] > cards[h]:
            return "gloo", local_rank, (
                f"{ranks[h]} ranks share {cards[h]} card"
                f"{'' if cards[h] == 1 else 's'} on host {h}, which NCCL "
                "refuses")
    return "nccl", local_rank, ", ".join(
        f"{ranks[h]} ranks on {cards[h]} cards of host {h}" for h in ranks)


def _layout(store, num_processes, process_id):
    """Every rank's (host name, card count), posted to and read from the
    coordinator's store."""
    store.set(f"layout/{process_id}",
              f"{torch.cuda.device_count()} {socket.gethostname()}")
    layout = []
    for i in range(num_processes):
        cards, host = store.get(f"layout/{i}").decode().split(" ", 1)
        layout.append((host, int(cards)))
    return layout


def initialize(coordinator, num_processes, process_id, device):
    """Join the group of ``num_processes`` ranks at ``coordinator``
    ('host:port' of rank 0).  Returns the device this rank runs on."""
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    backend, local_rank, why = choose_backend(
        device, _layout(store, num_processes, process_id), process_id)
    if torch.device(device).type == "cuda":
        device = torch.device("cuda",
                              local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    print(f"torch.distributed: rank {process_id} of {num_processes}, "
          f"backend {backend} ({why}), device {device}", flush=True)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return device


@contextlib.contextmanager
def session(flags, device):
    """CLI hook: with ``--coordinator`` set (and no group yet), this
    process joins the group for the body and leaves it after; yields the
    device the body runs on.  Otherwise a no-op that yields ``device``."""
    if not flags.coordinator or dist.is_initialized():
        yield device
        return
    device = initialize(flags.coordinator, flags.num_processes,
                        flags.process_id, device)
    try:
        yield device
    finally:
        dist.destroy_process_group()


def world():
    """(number of processes, this process's rank)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_slice(n, num_processes=None, process_id=None):
    """The contiguous [start, stop) slice of n items owned by this
    process (block partitioning; the first ``n % p`` ranks get one
    extra item)."""
    size, rank = world()
    p = num_processes if num_processes is not None else size
    i = process_id if process_id is not None else rank
    base, rem = divmod(n, p)
    start = i * base + min(i, rem)
    return start, start + base + (1 if i < rem else 0)


def _staged(t):
    """The tensor a collective runs on: ``t`` itself, or a host copy of a
    CUDA tensor under gloo."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.cpu()
    return t


def all_reduce_sum(t, group=None):
    """Sum ``t`` over the ranks of ``group`` (default: all of them);
    returns the sum (``t`` is left as it was)."""
    staged = _staged(t.detach()).clone()
    dist.all_reduce(staged, group=group)
    return staged.to(t.device)


def all_gather_cat(t, group=None, dim=0):
    """Every rank's ``t`` (equal shapes) of ``group``, concatenated along
    ``dim`` in the group's rank order."""
    staged = _staged(t.detach()).contiguous()
    parts = [torch.empty_like(staged)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over the group's ranks.  Backward: the sum over
    them of the incoming gradients, so each rank's gradient through the
    sum is that of every rank's loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


def all_reduce_sum_differentiable(t, group=None):
    """``all_reduce_sum`` inside autograd (``_SumOverRanks``)."""
    return _SumOverRanks.apply(t, group)


class _CopyToShards(torch.autograd.Function):
    """The input of a row-sharded product (tensor parallelism).  Forward:
    the tensor itself, which every rank of ``group`` holds whole and
    multiplies by its rows of the weight.  Backward: the sum over the
    group of the incoming gradients, each rank's share ``dy_m W_m`` of
    the input's gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """The output of a row-sharded product (tensor parallelism).
    Forward: every rank's columns side by side along the last dim, in
    the group's rank order.  Backward: this rank's columns of the
    incoming gradient.  Everything after the gather is replicated, so
    every rank holds the same whole gradient and its own columns are its
    shard's; a reduce-scatter would multiply them by the group's size."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.rank, ctx.width = dist.get_rank(group), t.shape[-1]
        return all_gather_cat(t, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.rank * ctx.width
        return grad[..., start:start + ctx.width], None


def copy_to_shards(t, group):
    """``t`` as the input of a product sharded over ``group``
    (``_CopyToShards``)."""
    return _CopyToShards.apply(t, group)


def gather_columns(t, group):
    """The ranks' columns of ``group`` side by side (``_GatherColumns``)."""
    return _GatherColumns.apply(t, group)


def barrier():
    if world()[0] > 1:
        dist.barrier()


def allgather_rows(local):
    """Each rank's ``local`` (n_r, ...) numpy rows -> every rank's rows in
    rank order, on every rank.  The ragged slices are padded to the
    longest, gathered and trimmed."""
    size, _ = world()
    if size == 1:
        return local
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    counts = [torch.zeros(1, dtype=torch.int64, device=device)
              for _ in range(size)]
    dist.all_gather(counts, torch.tensor([local.shape[0]], device=device))
    counts = [int(c.item()) for c in counts]
    padded = np.zeros((max(counts),) + local.shape[1:], local.dtype)
    padded[:local.shape[0]] = local
    parts = [torch.empty(padded.shape, dtype=torch.from_numpy(padded).dtype,
                         device=device) for _ in range(size)]
    dist.all_gather(parts, torch.from_numpy(padded).to(device))
    return np.concatenate([p[:c].cpu().numpy()
                           for p, c in zip(parts, counts)], axis=0)
