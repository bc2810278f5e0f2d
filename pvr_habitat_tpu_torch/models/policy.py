"""The BC policy network (counterpart of ``pvr_habitat_tpu/models/policy.py``).

``PolicyNet`` — MLP(obs->1024->1024) -> 2-layer LSTM(1024) -> policy +
baseline heads, optional input BatchNorm1d, orthogonal init
(reference: src/models.py:13-89).

``PolicyNetWithConv`` — the same head over raw pixels: per-frame 5x(conv3x3
s2, ELU) feature stack, frames concatenated, inputs scaled by 1/255
(reference: src/models.py:96-197; the finetune path only).  It runs in
torch's own layout: each frame goes through ``x.transpose(1, 3)`` as the
reference's does, so the convs see H and W swapped, and the maps are
concatenated along dim 3 and flattened in NCHW order.

Parameter keys mirror the torch module paths, as in the JAX package, so
checkpoints of either package load in the other:
  without batch_norm: fc.0 / fc.2 are the Linears;
  with batch_norm:    fc.0 is BatchNorm1d, fc.1 / fc.3 the Linears.
LSTM params: core.weight_ih_l{0,1} etc.  Heads: policy.*, baseline.*.

Model state is split into ``params`` (trained) and ``batch_stats``
(BatchNorm running mean/var, returned updated in train mode), so the
train step stays functional: flat dicts of tensors in, new dicts out.

On a mesh of ranks (``mesh``, ``parallel/mesh.py``) the batch is this
rank's columns of a global batch split over 'data', and train-mode
BatchNorm takes the global batch's statistics; over 'model', ``params``
holds this rank's rows of the sharded weights (``policy_param_spec``):
the two fc products and the LSTM gates are computed on those rows and
gathered, and a replicated fc bias is added after the gather.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from pvr_habitat_tpu_torch.models import common as cm
from pvr_habitat_tpu_torch.models import convert
from pvr_habitat_tpu_torch.ops.lstm import lstm_scan, stack_lstm_params
from pvr_habitat_tpu_torch.parallel import multihost
from pvr_habitat_tpu_torch.utils.platform import resolve_device

HIDDEN = 1024
LSTM_LAYERS = 2
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


# -----------------------------------------------------------------------------
# Init (the JAX package's numpy stream, draw for draw)
# -----------------------------------------------------------------------------


def _init_lstm(out, rng, input_size):
    k = 1.0 / math.sqrt(HIDDEN)
    for layer in range(LSTM_LAYERS):
        in_size = input_size if layer == 0 else HIDDEN
        out[f"core.weight_ih_l{layer}"] = rng.uniform(
            -k, k, size=(4 * HIDDEN, in_size)).astype(np.float32)
        out[f"core.weight_hh_l{layer}"] = rng.uniform(
            -k, k, size=(4 * HIDDEN, HIDDEN)).astype(np.float32)
        out[f"core.bias_ih_l{layer}"] = rng.uniform(
            -k, k, size=(4 * HIDDEN,)).astype(np.float32)
        out[f"core.bias_hh_l{layer}"] = rng.uniform(
            -k, k, size=(4 * HIDDEN,)).astype(np.float32)


def _init_heads(out, rng, num_actions):
    out["policy.weight"] = cm.orthogonal(rng, (num_actions, HIDDEN), gain=1.0)
    out["policy.bias"] = np.zeros(num_actions, np.float32)
    out["baseline.weight"] = cm.orthogonal(rng, (1, HIDDEN), gain=1.0)
    out["baseline.bias"] = np.zeros(1, np.float32)


def init_policy_params(rng, obs_size, num_actions, batch_norm=False,
                       device=None):
    """Returns (params, batch_stats), flat dicts of f32 tensors on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    gain = math.sqrt(2.0)  # calculate_gain('relu')
    params, stats = {}, {}
    fc0 = 1 if batch_norm else 0
    if batch_norm:
        params["fc.0.weight"] = np.ones(obs_size, np.float32)
        params["fc.0.bias"] = np.zeros(obs_size, np.float32)
        stats["fc.0.running_mean"] = np.zeros(obs_size, np.float32)
        stats["fc.0.running_var"] = np.ones(obs_size, np.float32)
    params[f"fc.{fc0}.weight"] = cm.orthogonal(rng, (HIDDEN, obs_size), gain)
    params[f"fc.{fc0}.bias"] = np.zeros(HIDDEN, np.float32)
    params[f"fc.{fc0 + 2}.weight"] = cm.orthogonal(rng, (HIDDEN, HIDDEN), gain)
    params[f"fc.{fc0 + 2}.bias"] = np.zeros(HIDDEN, np.float32)
    _init_lstm(params, rng, HIDDEN)
    _init_heads(params, rng, num_actions)
    return (convert.params_from_numpy(params, device),
            convert.params_from_numpy(stats, device))


def init_conv_policy_params(rng, obs_shape, num_actions, batch_norm=False,
                            device=None):
    """obs_shape = (H, W, C*n_frames) raw pixels.  Returns (params,
    batch_stats); the convs are OIHW."""
    device = resolve_device(device)
    h, w, cn = obs_shape
    n_frames = cn // 3
    gain = math.sqrt(2.0)
    params, stats = {}, {}
    ch_in = 3
    for i in range(5):
        params[f"feat_extract.{2 * i}.weight"] = cm.orthogonal_conv(
            rng, (32, ch_in, 3, 3), gain)
        params[f"feat_extract.{2 * i}.bias"] = np.zeros(32, np.float32)
        ch_in = 32
    side_h, side_w = h, w
    for _ in range(5):
        side_h = (side_h + 1) // 2
        side_w = (side_w + 1) // 2
    conv_out = 32 * side_h * side_w * n_frames

    fc0 = 1 if batch_norm else 0
    if batch_norm:
        params["fc.0.weight"] = np.ones(conv_out, np.float32)
        params["fc.0.bias"] = np.zeros(conv_out, np.float32)
        stats["fc.0.running_mean"] = np.zeros(conv_out, np.float32)
        stats["fc.0.running_var"] = np.ones(conv_out, np.float32)
    params[f"fc.{fc0}.weight"] = cm.orthogonal(rng, (HIDDEN, conv_out), gain)
    params[f"fc.{fc0}.bias"] = np.zeros(HIDDEN, np.float32)
    params[f"fc.{fc0 + 2}.weight"] = cm.orthogonal(rng, (HIDDEN, HIDDEN), gain)
    params[f"fc.{fc0 + 2}.bias"] = np.zeros(HIDDEN, np.float32)
    _init_lstm(params, rng, HIDDEN)
    _init_heads(params, rng, num_actions)
    # already in the port's layout: no HWIO -> OIHW bridge
    return ({k: torch.from_numpy(v).to(device) for k, v in params.items()},
            {k: torch.from_numpy(v).to(device) for k, v in stats.items()})


def initial_state(batch_size, device=None):
    """Zero (h, c), each (L, B, H) (reference: src/models.py:52-54)."""
    device = resolve_device(device)
    shape = (LSTM_LAYERS, batch_size, HIDDEN)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


# -----------------------------------------------------------------------------
# Forward
# -----------------------------------------------------------------------------


def _batch_norm_1d(x, params, batch_stats, train, mesh=None):
    """Train mode normalises with the biased batch variance and moves the
    running variance with the unbiased one, as torch's BatchNorm1d does.
    On a mesh with a 'data' axis the batch is sharded over the ranks of
    the data group in equal parts, and the statistics are the global
    batch's (the sums of x and of (x - mean)^2 over those ranks), as the
    JAX package computes them over a sharded batch; gradients flow
    through the sums to every rank."""
    gamma = params["fc.0.weight"]
    beta = params["fc.0.bias"]
    if not train:
        mean = batch_stats["fc.0.running_mean"]
        var = batch_stats["fc.0.running_var"]
        x = (x - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta
        return x, batch_stats
    if mesh is not None and mesh.data > 1:
        n = x.shape[0] * mesh.data
        mean = multihost.all_reduce_sum_differentiable(
            x.sum(dim=0), mesh.data_group) / n
        var = multihost.all_reduce_sum_differentiable(
            ((x - mean) ** 2).sum(dim=0), mesh.data_group) / n
    else:
        n = x.shape[0]
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
    unbiased = var * (n / max(n - 1, 1))
    new_stats = {
        "fc.0.running_mean": (1 - BN_MOMENTUM)
        * batch_stats["fc.0.running_mean"] + BN_MOMENTUM * mean.detach(),
        "fc.0.running_var": (1 - BN_MOMENTUM)
        * batch_stats["fc.0.running_var"]
        + BN_MOMENTUM * unbiased.detach(),
    }
    x = (x - mean) * torch.rsqrt(var + BN_EPS) * gamma + beta
    return x, new_stats


def _linear(x, params, prefix, model_group):
    """``cm.linear``; with ``model_group``, on this rank's rows of the
    weight, gathered, then the whole bias."""
    if model_group is None:
        return cm.linear(x, params, prefix)
    y = multihost.copy_to_shards(x, model_group) \
        @ params[f"{prefix}.weight"].T
    return multihost.gather_columns(y, model_group) \
        + params[f"{prefix}.bias"]


def _trunk_to_outputs(x, params, done, core_state, fc0, t, b, train,
                      generator, mesh):
    """Shared tail: the two ReLU linears, the LSTM unroll, the heads and
    the action choice."""
    group = mesh.model_group if mesh is not None and mesh.model > 1 \
        else None
    x = torch.relu(_linear(x, params, f"fc.{fc0}", group))
    x = torch.relu(_linear(x, params, f"fc.{fc0 + 2}", group))
    notdone = 1.0 - done.float()
    layers = stack_lstm_params(params, "core", LSTM_LAYERS)
    core_out, new_state = lstm_scan(layers, x.reshape(t, b, HIDDEN),
                                    core_state[0], core_state[1], notdone,
                                    group)
    flat = core_out.reshape(t * b, HIDDEN)
    logits = cm.linear(flat, params, "policy")
    baseline = cm.linear(flat, params, "baseline")
    if train:
        if generator is None:
            raise ValueError("train-mode action sampling needs a generator")
        action = torch.multinomial(torch.softmax(logits.detach(), dim=-1), 1,
                                   generator=generator)
    else:
        action = torch.argmax(logits, dim=-1)
    outputs = dict(policy_logits=logits.reshape(t, b, -1),
                   baseline=baseline.reshape(t, b),
                   action=action.reshape(t, b))
    return outputs, new_state


def apply_policy(params, batch_stats, inputs, core_state, *, batch_norm=False,
                 train=False, generator=None, mesh=None):
    """PolicyNet forward.

    inputs: dict(obs=(T, B, O) float, done=(T, B) bool-ish).
    ``generator`` (a ``torch.Generator`` on the params' device) draws the
    train-mode actions, sampled from the logits as the reference does;
    eval mode takes the argmax.  ``mesh``: this rank's place on a mesh
    of ranks (see the module docstring), or None for one process.
    Returns (outputs, new_core_state, new_batch_stats).
    """
    obs, done = inputs["obs"], inputs["done"]
    t, b = obs.shape[0], obs.shape[1]
    x = obs.reshape(t * b, -1).float()

    new_stats = batch_stats
    fc0 = 0
    if batch_norm:
        x, new_stats = _batch_norm_1d(x, params, batch_stats, train,
                                      mesh)
        fc0 = 1
    outputs, new_state = _trunk_to_outputs(x, params, done, core_state, fc0,
                                           t, b, train, generator, mesh)
    return outputs, new_state, new_stats


def apply_conv_policy(params, batch_stats, inputs, core_state, *,
                      batch_norm=False, train=False, generator=None,
                      mesh=None):
    """PolicyNetWithConv forward over raw pixels.

    inputs: dict(obs=(T, B, H, W, C*n) uint8 or float, done=(T, B)).
    Returns (outputs, new_core_state, new_batch_stats), as
    ``apply_policy``."""
    obs, done = inputs["obs"], inputs["done"]
    t, b, h, w, cn = obs.shape
    x = obs.reshape(t * b, h, w, cn).float() / 255.0
    feats = []
    for f in range(cn // 3):
        # (N, H, W, 3) -> (N, 3, W, H): the reference's x.transpose(1, 3)
        # (src/models.py:169), so the convs run over swapped H and W
        y = x[..., 3 * f:3 * (f + 1)].transpose(1, 3)
        for i in range(5):
            y = F.elu(F.conv2d(y, params[f"feat_extract.{2 * i}.weight"],
                               params[f"feat_extract.{2 * i}.bias"], 2, 1))
        feats.append(y)
    # the (N, 32, W', H') maps side by side along dim 3, flattened NCHW
    x = torch.cat(feats, dim=3).reshape(t * b, -1)

    new_stats = batch_stats
    fc0 = 0
    if batch_norm:
        x, new_stats = _batch_norm_1d(x, params, batch_stats, train,
                                      mesh)
        fc0 = 1
    outputs, new_state = _trunk_to_outputs(x, params, done, core_state, fc0,
                                           t, b, train, generator, mesh)
    return outputs, new_state, new_stats
