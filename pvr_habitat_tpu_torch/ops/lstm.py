"""Multi-layer LSTM with done-masked state resets (counterpart of
``pvr_habitat_tpu/ops/lstm.py``).

The reference runs a 2-layer torch LSTM one timestep at a time in a
Python loop, multiplying the carried (h, c) by ``notdone`` before every
step, step 0 included (reference: src/models.py:66-73).  A single
``nn.LSTM`` call cannot reset its state inside the unroll, so this is
that loop, with torch's gate order and equations:

    i, f, g, o = split4(x @ Wih^T + h @ Whh^T + bih + bhh)
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

The products are plain ``torch.matmul``; the JAX package also computes
them outside any Pallas kernel.

Tensor parallelism (``model_group``): each rank holds its contiguous
rows of the 4H gate rows (weights and biases), computes those gates and
gathers the whole 4H over the group before the split into i, f, g, o
(with 2 ranks, rank 0 holds i and f).  The inputs x and h enter the
products through ``multihost.copy_to_shards``, whose backward sums the
ranks' shares of their gradients.
"""

import torch

from pvr_habitat_tpu_torch.parallel import multihost
from pvr_habitat_tpu_torch.utils.profiling import span


def stack_lstm_params(flat, prefix, num_layers):
    """Collect torch-named LSTM params ('{prefix}.weight_ih_l{k}', ...)
    into per-layer tuples."""
    return [(flat[f"{prefix}.weight_ih_l{layer}"],
             flat[f"{prefix}.weight_hh_l{layer}"],
             flat[f"{prefix}.bias_ih_l{layer}"],
             flat[f"{prefix}.bias_hh_l{layer}"])
            for layer in range(num_layers)]


def _cell(x, h, c, wih, whh, bih, bhh, model_group=None):
    if model_group is not None:
        x = multihost.copy_to_shards(x, model_group)
        h = multihost.copy_to_shards(h, model_group)
    gates = torch.matmul(x, wih.T) + torch.matmul(h, whh.T) + bih + bhh
    if model_group is not None:
        gates = multihost.gather_columns(gates, model_group)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_scan(layers, x, h0, c0, notdone, model_group=None):
    """Run the unroll.

    Args:
      layers: list of (wih, whh, bih, bhh) per layer; with
        ``model_group``, this rank's rows of the gates.
      x: (T, B, In) inputs.
      h0, c0: (L, B, H) initial states.
      notdone: (T, B) float mask; the carried state is multiplied by
        ``notdone[t]`` BEFORE step t (episode boundaries reset state).
      model_group: the ranks the gate rows are sharded over, or None.

    Returns: (ys (T, B, H) top-layer outputs, (hT, cT)).

    The whole unroll is one ``policy.lstm`` span (``utils/profiling.py``).
    """
    with span("policy.lstm"):
        h = list(h0.unbind(0))
        c = list(c0.unbind(0))
        ys = []
        for t in range(x.shape[0]):
            nd = notdone[t][:, None]
            inp = x[t]
            for layer, params in enumerate(layers):
                h[layer], c[layer] = _cell(inp, h[layer] * nd,
                                           c[layer] * nd, *params,
                                           model_group)
                inp = h[layer]
            ys.append(inp)
        return torch.stack(ys), (torch.stack(h), torch.stack(c))
