"""The PVR BC policy (arXiv:2203.03580; the reference repo's
src/models.py PolicyNet) and its training step, float32.

Forward: ReLU(Linear(obs, 1024)), ReLU(Linear(1024, 1024)), a 2-layer
LSTM stepped one timestep at a time with the carried (h, c) multiplied
by ``1 - done[t]`` before step t, then the policy and baseline heads.
Training step (main_bc_2.py): mean cross entropy of the policy logits
against the expert actions over all T x B, the gradient, the global
L2 norm before clipping to ``max_grad_norm``, and torch's RMSprop
(square average from zero, eps outside the square root) at the
learning rate ``lr * (1 - (k + 1) / max_epochs)`` for step k, the
scheduler being stepped before the optimizer.
"""

import torch
import torch.nn.functional as F


def _lstm_layer(x, h, c, w, layer):
    gates = (x @ w[f"core.weight_ih_l{layer}"].T
             + h @ w[f"core.weight_hh_l{layer}"].T
             + w[f"core.bias_ih_l{layer}"] + w[f"core.bias_hh_l{layer}"])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def forward(w, obs, done, state, pol):
    """obs (T, B, O), done (T, B), state (h, c) each (L, B, H) ->
    (logits (T, B, A), (h, c))."""
    t_len, b = done.shape
    x = F.relu(F.linear(obs.reshape(t_len * b, -1), w["fc.0.weight"],
                        w["fc.0.bias"]))
    x = F.relu(F.linear(x, w["fc.2.weight"], w["fc.2.bias"]))
    x = x.view(t_len, b, -1)
    h, c = list(state[0]), list(state[1])
    outs = []
    for t in range(t_len):
        keep = (1.0 - done[t].float())[:, None]
        y = x[t]
        for layer in range(pol["lstm_layers"]):
            h[layer], c[layer] = _lstm_layer(y, h[layer] * keep,
                                             c[layer] * keep, w, layer)
            y = h[layer]
        outs.append(y)
    logits = F.linear(torch.stack(outs), w["policy.weight"],
                      w["policy.bias"])
    return logits, (torch.stack(h), torch.stack(c))


def zero_state(pol, batch, device):
    shape = (pol["lstm_layers"], batch, pol["hidden_size"])
    return torch.zeros(shape, device=device), torch.zeros(shape,
                                                          device=device)


def gather(data, starts, unroll):
    """The unroll of every start: rows (start + t) mod N, as (T, B, ...)."""
    n = data["obs"].shape[0]
    rows = torch.stack([(torch.arange(unroll) + s) % n for s in starts],
                       dim=1).to(data["obs"].device)
    return {k: v[rows] for k, v in data.items()}


def train(w, data, starts_per_step, pol, square=None, first_step=0):
    """The steps on the unrolls of ``starts_per_step``, from ``w`` and
    RMSprop's square average ``square`` (zero when None), the first of
    them the trainer's step ``first_step`` (counted from 0) for the
    learning rate's schedule.

    Returns dict(loss=[per step], grad_norm=[pre-clip, per step],
    first_grads={leaf: the first step's clipped gradient},
    params={leaf: after the last step})."""
    max_epochs = pol["max_frames"] // (len(starts_per_step[0])
                                       * pol["unroll"]) + 1
    params = {k: v.clone() for k, v in w.items()}
    square = {k: torch.zeros_like(v) if square is None else square[k].clone()
              for k, v in w.items()}
    out = dict(loss=[], grad_norm=[], first_grads=None)
    for k, starts in enumerate(starts_per_step):
        batch = gather(data, starts, pol["unroll"])
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        logits, _ = forward(leaves, batch["obs"], batch["done"],
                            zero_state(pol, len(starts), batch["obs"].device),
                            pol)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch["action"].reshape(-1))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(leaves.items(), grads)}
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = torch.clamp(pol["max_grad_norm"] / (norm + 1e-6), max=1.0)
            grads = {n: g * scale for n, g in grads.items()}
            if k == 0:
                out["first_grads"] = grads
            lr = pol["learning_rate"] * (1.0 - (first_step + k + 1)
                                         / max_epochs)
            for n, g in grads.items():
                square[n] = pol["alpha"] * square[n] + (1 - pol["alpha"]) * g * g
                params[n] = params[n] - lr * g / (torch.sqrt(square[n])
                                                  + pol["epsilon"])
        out["loss"].append(float(loss.detach()))
        out["grad_norm"].append(float(norm))
    out["params"] = params
    return out
