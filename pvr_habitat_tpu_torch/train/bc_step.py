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

The JAX package's fused-gather and chunked steps exist to save
dispatches (one per epoch, one per eval block).  Eager PyTorch pays a
host launch for each of a step's small kernels (about 9,650 at B 32,
T 100), more time than the device spends on them; here the saving is a
CUDA graph instead.  On
a CUDA device, in one process or on a mesh of one rank,
``make_train_step`` captures ``step_body`` once per signature (the
batch's and the state's shapes and dtypes, and the action generator)
and replays it on every later call; elsewhere (the CPU, a mesh of more
ranks, whose collectives stay eager) it runs ``step_body`` as it is.
The graph's kernels are the eager step's.  K steps on the batches that
``sampler.gather_unrolls`` indexes on the data's device give the losses
of the JAX package's fused and chunked steps.

Spans (``utils/profiling.py``): ``train.step`` (every call),
``train.graph`` (a graphed call's copies in, replay and copies out);
inside ``step_body``, so on the graphed path only while it is captured:
``train.forward`` (the policy and the loss), ``train.backward`` (the
gradients), ``train.clip`` and ``train.optimizer`` (the update and its
application).
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
              max_grad_norm=40.0, mesh=None, lr=None):
    """One epoch on a gathered batch dict(obs, action, done) of (T, B,
    ...) tensors.  Returns (new_state, dict(loss, gradient_norm)).
    ``lr``: the update's lr tensor (``opt.update``), by default the one
    of ``state``'s count."""
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
        updates, new_opt_state = opt.update(grads, state.opt_state, lr)
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


def captures(device, mesh):
    """Whether ``make_train_step`` replays its step from a CUDA graph for a
    batch on ``device``: on a CUDA device, with no mesh or a mesh of one
    rank."""
    return device.type == "cuda" and (
        mesh is None or (mesh.data == 1 and mesh.model == 1))


def _state_tensors(state):
    """The tensors of a ``TrainState``, by (part, key)."""
    opt = state.opt_state
    parts = dict(params=state.params, batch_stats=state.batch_stats,
                 square_avg=opt.square_avg,
                 momentum_buf=opt.momentum_buf or {})
    return {(part, k): v for part, tensors in parts.items()
            for k, v in tensors.items()}


def _rebuild(state, tensors, count):
    """``state`` with the tensors of ``tensors`` (by (part, key), as
    ``_state_tensors`` gives them) and the step count ``count``."""
    def part(name, like):
        return {k: tensors[name, k] for k in like}

    opt = state.opt_state
    return TrainState(
        part("params", state.params),
        part("batch_stats", state.batch_stats),
        optim.RMSpropTorchState(
            count, part("square_avg", opt.square_avg),
            part("momentum_buf", opt.momentum_buf)
            if opt.momentum_buf != () else ()),
        state.generator)


def signature(state, batch):
    """What one captured graph serves: the shapes, dtypes and devices of
    the batch and of the state, and the state's generator."""
    def layout(tensors):
        return tuple((k, tuple(v.shape), v.dtype, v.device)
                     for k, v in sorted(tensors.items()))

    return layout(batch), layout(_state_tensors(state)), state.generator


class _GraphedStep:
    """``body(state, batch, lr)`` captured in one CUDA graph and replayed.

    The graph reads static copies of the state, the batch and the lr
    and writes static outputs.  A call copies its state and batch in,
    fills the lr from ``opt.lr(count)``, replays and clones the outputs
    out: the caller's tensors are never written, so a state kept from
    before steps again as it did.  The eager step before the capture
    runs on the static copies and the generator's state is put back
    after it; the generator is registered with the graph, so every
    replay draws afresh and k replays leave it where k eager steps
    would.  (``torch.cuda.graph``'s ``gc.collect`` and ``empty_cache``
    before a capture only free memory, and are left out.)"""

    def __init__(self, body, opt, state, batch):
        self.opt = opt
        self.device = batch["action"].device
        with torch.cuda.device(self.device):
            self.lr = torch.zeros((), dtype=torch.float32,
                                  device=self.device)
            self.state_in = {k: v.clone()
                             for k, v in _state_tensors(state).items()}
            self.batch_in = {
                k: v.clone(memory_format=torch.contiguous_format)
                for k, v in batch.items()}
            static = _rebuild(state, self.state_in, state.opt_state.count)
            generator = state.generator
            saved = generator.get_state()
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                # one eager step first, on the capture's stream and done
                # before it: lazy set-up (cuBLAS's handle and workspace
                # for the stream, the autograd engine's thread) stays out
                # of the graph
                body(static, self.batch_in, self.lr)
                generator.set_state(saved)
                torch.cuda.synchronize(self.device)
                self.graph.register_generator_state(generator)
                self.graph.capture_begin()
                try:
                    out, self.metrics = body(static, self.batch_in, self.lr)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(self.device).wait_stream(stream)
        self.state_out = _state_tensors(out)

    def __call__(self, state, batch):
        given = _state_tensors(state)
        keys = list(self.state_in)
        with torch.cuda.device(self.device):
            torch._foreach_copy_([self.state_in[k] for k in keys],
                                 [given[k] for k in keys])
            torch._foreach_copy_(list(self.batch_in.values()),
                                 [batch[k] for k in self.batch_in])
            count = state.opt_state.count
            self.lr.fill_(float(self.opt.lr(count)))
            self.graph.replay()
            out = {k: v.clone() for k, v in self.state_out.items()}
            metrics = {k: v.clone() for k, v in self.metrics.items()}
        return _rebuild(state, out, count + 1), metrics


def make_train_step(opt, *, batch_norm=False, conv_policy=False,
                    max_grad_norm=40.0, mesh=None):
    """Returns step(state, batch) -> (state, metrics).

    batch: dict(obs=(T, B, ...), action=(T, B), done=(T, B)) tensors; obs
    are uint8 frames (T, B, H, W, C) for the conv policy.
    metrics: dict(loss, gradient_norm) — pre-clip norm, as logged by the
    reference.  ``mesh``: this rank's place on a mesh of ranks (see the
    module docstring), or None for one process.  Where ``captures``
    holds, each signature's first call captures a CUDA graph of the
    step, which that call and every later one replay.
    """
    def body(state, batch, lr=None):
        return step_body(state, batch, opt, batch_norm=batch_norm,
                         conv_policy=conv_policy, max_grad_norm=max_grad_norm,
                         mesh=mesh, lr=lr)

    graphs = {}

    def step(state, batch):
        with span("train.step"):
            if not captures(batch["action"].device, mesh):
                return body(state, batch)
            key = signature(state, batch)
            if key not in graphs:
                graphs[key] = _GraphedStep(body, opt, state, batch)
            with span("train.graph"):
                return graphs[key](state, batch)

    return step
