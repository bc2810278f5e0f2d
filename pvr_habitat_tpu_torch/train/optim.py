"""Optimizer with the reference's exact torch semantics (counterpart of
``pvr_habitat_tpu/train/optim.py``).

- torch.optim.RMSprop: square_avg starts at ZERO, eps is added OUTSIDE
  the sqrt, optional momentum buffer (reference: main_bc_2.py:80-85).
- LambdaLR linear decay with the scheduler stepped BEFORE the optimizer
  each iteration (reference quirk, main_bc_2.py:216-227): the lr applied
  at global epoch k (0-based) is  base_lr * (1 - (k+1) / max_epochs).
- clip_grad_norm_(40): global L2 norm across all grads; the logged
  gradient-norm metric is the PRE-clip norm (main_bc_2.py:220-226).

Written as functions of flat dicts, like the JAX transform, so that the
state is the JAX package's layout (``count``, ``square_avg`` and
``momentum_buf`` keyed by parameter name) and checkpoints interoperate.
``count`` is a host integer: the lr factor is computed on the host in
float32, as the JAX transform computes it on the device, and applied
from a 0-d float32 tensor on the params' device, so that a CUDA graph
of the step reads it from a buffer its caller fills before each replay
(``train/bc_step.py``).
"""

from typing import NamedTuple

import numpy as np
import torch

from pvr_habitat_tpu_torch.parallel import multihost


class RMSpropTorchState(NamedTuple):
    count: int              # number of optimizer steps taken so far
    square_avg: dict
    momentum_buf: object    # dict of tensors, or () without momentum


class RMSpropTorch:
    """init(params) -> state; update(grads, state) -> (updates, state).
    ``updates`` are added to the params (``apply_updates``)."""

    def __init__(self, base_lr, alpha=0.99, eps=1e-5, momentum=0.0,
                 max_epochs=None):
        self.base_lr = base_lr
        self.alpha = alpha
        self.eps = eps
        self.momentum = momentum
        self.max_epochs = max_epochs

    def init(self, params):
        return RMSpropTorchState(
            count=0,
            square_avg={k: torch.zeros_like(v) for k, v in params.items()},
            momentum_buf={k: torch.zeros_like(v) for k, v in params.items()}
            if self.momentum else ())

    def lr(self, count):
        """The lr of the step after ``count`` steps, in float32."""
        if self.max_epochs is None:
            return np.float32(self.base_lr)
        # scheduler.step() precedes optimizer.step(), so step k uses
        # the factor for epoch k+1.
        factor = np.float32(1.0) - (np.float32(count) + np.float32(1.0)) \
            / np.float32(self.max_epochs)
        return np.float32(self.base_lr) * factor

    @torch.no_grad()
    def update(self, grads, state, lr=None):
        """``lr``: the step's lr, a 0-d float32 tensor on the grads'
        device; by default ``lr(state.count)`` in a new one."""
        alpha = self.alpha
        sq = {k: alpha * state.square_avg[k] + (1.0 - alpha) * g * g
              for k, g in grads.items()}
        step_dir = {k: g / (torch.sqrt(sq[k]) + self.eps)
                    for k, g in grads.items()}
        buf = ()
        if self.momentum:
            buf = {k: self.momentum * state.momentum_buf[k] + d
                   for k, d in step_dir.items()}
            step_dir = buf
        if lr is None:
            lr = torch.full((), float(self.lr(state.count)),
                            dtype=torch.float32,
                            device=next(iter(grads.values())).device)
        neg_lr = -lr
        updates = {k: neg_lr * d for k, d in step_dir.items()}
        return updates, RMSpropTorchState(state.count + 1, sq, buf)


@torch.no_grad()
def apply_updates(params, updates):
    return {k: p + updates[k] for k, p in params.items()}


@torch.no_grad()
def clip_by_global_norm_torch(grads, max_norm, sharded=(), group=None):
    """torch clip_grad_norm_: returns (clipped_grads, pre_clip_norm), the
    norm a 0-d tensor on the grads' device.  ``sharded``: the keys whose
    grads are this rank's rows of a parameter split over the ranks of
    ``group`` (tensor parallelism); their squares are summed over the
    group and the replicated grads' counted once, so every rank clips by
    the whole parameters' norm."""
    sq = sum(torch.sum(g * g) for k, g in grads.items() if k not in sharded)
    if sharded:
        sq = sq + multihost.all_reduce_sum(
            sum(torch.sum(grads[k] * grads[k]) for k in sorted(sharded)),
            group)
    gnorm = torch.sqrt(sq)
    coef = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return {k: g * coef for k, g in grads.items()}, gnorm
