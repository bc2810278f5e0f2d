"""The BC train step (counterpart of ``pvr_habitat_tpu/train/bc_step.py``).

One step does what the reference's per-epoch Python body does
(main_bc_2.py:186-227): forward (MLP -> LSTM loop -> heads), NLL loss
against expert actions, grad, pre-clip global grad-norm metric,
clip(40), torch-RMSprop update with the linear-decay factor.  The state
is functional (flat dicts of tensors in, new ones out), as in the JAX
package, and the metrics stay 0-d tensors on the device until a caller
reads them.

On a mesh of ranks (``mesh``, ``parallel/mesh.py``), data parallelism:
the batch is this rank's columns of a global batch sharded in equal
parts over the mesh's 'data' axis.  The BatchNorm statistics are the
global batch's, the gradients are summed over the rank's data group and
divided by its size before the pre-clip norm and the clip, and the
logged loss is the global mean.  Tensor parallelism: the params are
this rank's rows of the sharded weights (``policy_param_spec``), their
gradients are those rows' (averaged over the data group like the
replicated ones), the pre-clip norm sums the sharded squares over the
model group, and RMSprop's state shards like its params.  So every rank
takes its part of the step one device takes on the global batch (the
JAX package's sharded step, where XLA places the collectives).

The JAX package's fused-gather and chunked steps exist only to save
dispatches (one per epoch, one per eval block).  Eager PyTorch has no
such cost to save: K of its steps on the batches that
``sampler.gather_unrolls`` indexes on the data's device give the
losses of either.

Spans (``utils/profiling.py``): ``train.forward`` (the policy and the
loss), ``train.backward`` (the gradients), ``train.clip`` and
``train.optimizer`` (the update and its application).
"""

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from pvr_habitat_tpu_torch.models import policy as policy_mod
from pvr_habitat_tpu_torch.parallel import mesh as pmesh
from pvr_habitat_tpu_torch.parallel import multihost
from pvr_habitat_tpu_torch.train import optim
from pvr_habitat_tpu_torch.utils.platform import resolve_device
from pvr_habitat_tpu_torch.utils.profiling import span


class TrainState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: optim.RMSpropTorchState
    generator: torch.Generator    # draws the train-mode sampled actions


def create_train_state(rng_np, obs_shape, num_actions, flags, *,
                       conv_policy=False, max_epochs=None, seed=0,
                       device=None):
    """Fresh TrainState + the optimizer, on ``device`` (``cuda`` unless
    the caller asks for the CPU).  ``conv_policy``: the finetune path's
    policy over raw pixels of ``obs_shape`` (H, W, C)."""
    device = resolve_device(device)
    if conv_policy:
        params, stats = policy_mod.init_conv_policy_params(
            rng_np, obs_shape, num_actions, batch_norm=flags.batch_norm,
            device=device)
    else:
        params, stats = policy_mod.init_policy_params(
            rng_np, obs_shape[0], num_actions, batch_norm=flags.batch_norm,
            device=device)
    opt = optim.RMSpropTorch(
        flags.learning_rate, alpha=flags.alpha, eps=flags.epsilon,
        momentum=flags.momentum, max_epochs=max_epochs)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return TrainState(params, stats, opt.init(params), generator), opt


def _map_sharded(fn, mesh, state):
    opt = state.opt_state
    return state._replace(
        params=fn(mesh, state.params),
        opt_state=opt._replace(
            square_avg=fn(mesh, opt.square_avg),
            momentum_buf=opt.momentum_buf if opt.momentum_buf == ()
            else fn(mesh, opt.momentum_buf)))


def shard_state(mesh, state):
    """This rank's part of a whole ``TrainState`` on a mesh with a 'model'
    axis: its rows of the sharded params and of RMSprop's ``square_avg``
    and ``momentum_buf``; the BatchNorm statistics and the step count are
    replicated (the JAX trainer's ``_shard_state``)."""
    return _map_sharded(pmesh.shard_params, mesh, state)


def gather_state(mesh, state):
    """The whole ``TrainState`` from every rank's part (over its model
    group): what a checkpoint holds and online eval runs on."""
    return _map_sharded(pmesh.gather_params, mesh, state)


def nll_loss(logits, actions):
    """F.nll_loss(F.log_softmax(logits), target): mean cross entropy
    over the merged (T*B) axis (reference: main_bc_2.py:211-214)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           actions.reshape(-1).long())


def step_body(state, batch, opt, *, batch_norm=False, conv_policy=False,
              max_grad_norm=40.0, mesh=None):
    """One epoch on a gathered batch dict(obs, action, done) of (T, B,
    ...) tensors.  Returns (new_state, dict(loss, gradient_norm))."""
    b = batch["action"].shape[1]
    params = {k: v.detach().requires_grad_() for k, v in
              state.params.items()}
    apply_fn = (policy_mod.apply_conv_policy if conv_policy
                else policy_mod.apply_policy)
    with span("train.forward"):
        outputs, _, new_stats = apply_fn(
            params, state.batch_stats,
            dict(obs=batch["obs"], done=batch["done"]),
            policy_mod.initial_state(b, batch["obs"].device),
            batch_norm=batch_norm, train=True, generator=state.generator,
            mesh=mesh)
        loss = nll_loss(outputs["policy_logits"], batch["action"])
    with span("train.backward"):
        # The baseline head is not in the loss: its grads are zeros, as
        # jax.grad gives them.
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
    loss = loss.detach()
    sharded, group = (), None
    if mesh is not None:
        if mesh.data > 1:
            grads, loss = _average_over_ranks(grads, loss, mesh)
        if mesh.model > 1:
            sharded, group = pmesh.sharded_keys(grads), mesh.model_group
    with span("train.clip"):
        grads, gnorm = optim.clip_by_global_norm_torch(grads, max_grad_norm,
                                                       sharded, group)
    with span("train.optimizer"):
        updates, new_opt_state = opt.update(grads, state.opt_state)
        new_params = optim.apply_updates(state.params, updates)
    new_state = TrainState(new_params, new_stats, new_opt_state,
                           state.generator)
    return new_state, dict(loss=loss, gradient_norm=gnorm)


def _average_over_ranks(grads, loss, mesh):
    """The mean over the data group's ranks of every gradient and of the
    loss, by one all-reduce of one flat buffer (equal shards: the mean of
    the ranks' means is the global batch's)."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()]
                     + [loss.reshape(1)])
    flat = multihost.all_reduce_sum(flat, mesh.data_group) / mesh.data
    out, offset = {}, 0
    for k, g in grads.items():
        out[k] = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    return out, flat[offset]


def make_train_step(opt, *, batch_norm=False, conv_policy=False,
                    max_grad_norm=40.0, mesh=None):
    """Returns step(state, batch) -> (state, metrics).

    batch: dict(obs=(T, B, ...), action=(T, B), done=(T, B)) tensors; obs
    are uint8 frames (T, B, H, W, C) for the conv policy.
    metrics: dict(loss, gradient_norm) — pre-clip norm, as logged by the
    reference.  ``mesh``: this rank's place on a mesh of ranks (see the
    module docstring), or None for one process.
    """
    def step(state, batch):
        return step_body(state, batch, opt, batch_norm=batch_norm,
                         conv_policy=conv_policy, max_grad_norm=max_grad_norm,
                         mesh=mesh)

    return step
