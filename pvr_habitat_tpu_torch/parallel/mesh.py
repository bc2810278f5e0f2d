"""The device mesh and its sharding rules (counterpart of
``pvr_habitat_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ('data', 'model') mesh:
batches shard over 'data', and the policy's 1024-wide hidden layers and
the LSTM's 4H gate rows shard over 'model' (row-parallel products).  In
the port one process is one device, so the mesh is the processes of
``torch.distributed`` (one, without a group), laid out row-major as
``mesh_utils.create_device_mesh`` lays out devices: rank r has data
index ``r // model`` and model index ``r % model``.

- 'data': each rank takes its columns of the batch (its data index's),
  and the gradients and the BatchNorm statistics are summed over its
  data group, the ranks of its model index (``train/bc_step.py``,
  ``models/policy.py``).
- 'model': each rank holds its contiguous rows of every sharded weight
  (``policy_param_spec``); a sharded product is gathered over its model
  group, the ranks of its data index, and the gather's backward takes
  the rank's own columns (``parallel/multihost.py``).
"""

from typing import Any, NamedTuple

import torch.distributed as dist

from pvr_habitat_tpu_torch.parallel import multihost


class Mesh(NamedTuple):
    data: int
    model: int
    data_index: int = 0       # this rank's row: rank // model
    model_index: int = 0      # this rank's column: rank % model
    # the ranks of this column (same model index): gradient and
    # BatchNorm sums; None is every rank (no 'model' axis)
    data_group: Any = None
    # the ranks of this row (same data index): the sharded products'
    # gathers; None without a 'model' axis
    model_group: Any = None

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}


def parse_mesh_shape(text):
    """'4,2' -> (4, 2); '4' -> (4, 1); '' -> None."""
    if not text:
        return None
    parts = [int(p) for p in text.split(",")]
    return (parts[0], 1) if len(parts) == 1 else tuple(parts[:2])


def make_mesh(shape=None, n_devices=None):
    """shape: (data, model), or None for every process on 'data'.
    ``n_devices`` defaults to the number of processes.  When the mesh is
    the processes of a group (the trainer's case), it holds this rank's
    place and, with a 'model' axis, its two groups: every rank then
    makes every row's and column's group, in the same order, so every
    rank must call this."""
    size, rank = multihost.world()
    n = n_devices if n_devices is not None else size
    if shape is None:
        shape = (n, 1)
    d, m = tuple(shape)
    if d * m != n:
        raise ValueError(f"mesh {(d, m)} != {n} devices")
    if n != size or size == 1:
        return Mesh(d, m)
    mesh = Mesh(d, m, data_index=rank // m, model_index=rank % m)
    if m == 1:
        return mesh
    rows = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    columns = [dist.new_group([i * m + j for i in range(d)])
               for j in range(m)]
    return mesh._replace(data_group=columns[mesh.model_index],
                         model_group=rows[mesh.data_index])


# -- sharding rules -----------------------------------------------------------
# A spec names, per dim of a parameter, the mesh axis it is split over
# (the JAX rules' PartitionSpec as a tuple): ("model", None) splits the
# rows, () replicates.


def policy_param_spec(name, shape):
    """TP rules for policy params (flat torch-named keys), the JAX
    rules: the fc weights' rows and the LSTM's 4H gate rows (weights and
    biases) over 'model'; fc biases, BatchNorm, the heads and the conv
    stem replicated (a replicated bias is added after the gather)."""
    if name.startswith("fc.") and name.endswith(".weight") and len(shape) == 2:
        return ("model", None)            # (1024, in): row-parallel
    if ".weight_ih_" in name or ".weight_hh_" in name:
        return ("model", None)            # (4H, in): gate rows sharded
    if ".bias_ih_" in name or ".bias_hh_" in name:
        return ("model",)
    return ()                             # heads, BN, conv stem


def encoder_param_spec(name, shape):
    """TP rules for encoder params, the JAX rule in the port's layout:
    the widest outputs (>= 512) over 'model', a conv's O of OIHW (the
    JAX rule's O of HWIO) and a linear's rows.  Neither package places
    an encoder with it."""
    if len(shape) == 4 and shape[0] >= 512:
        return ("model", None, None, None)
    if len(shape) == 2 and shape[0] >= 512:
        return ("model", None)
    return ()


def _sharded(rule, name, value):
    return rule(name, tuple(value.shape))[:1] == ("model",)


def sharded_keys(params, rule=policy_param_spec):
    """The keys of ``params`` whose rows split over 'model'."""
    return {k for k, v in params.items() if _sharded(rule, k, v)}


def shard_params(mesh, params, rule=policy_param_spec):
    """This rank's params: its contiguous rows (of its model index) of
    each sharded one, the rest whole."""
    if mesh.model == 1:
        return params
    out = {}
    for name, value in params.items():
        if _sharded(rule, name, value):
            rows = value.shape[0]
            if rows % mesh.model:
                raise ValueError(f"{name}: {rows} rows do not split over "
                                 f"a 'model' axis of {mesh.model}")
            per = rows // mesh.model
            value = value[mesh.model_index * per:
                          (mesh.model_index + 1) * per].clone()
        out[name] = value
    return out


def gather_params(mesh, params, rule=policy_param_spec):
    """The whole params from every rank's rows (over its model group);
    ``shard_params`` undone."""
    if mesh.model == 1:
        return params
    return {name: multihost.all_gather_cat(value, mesh.model_group)
            if _sharded(rule, name, value) else value
            for name, value in params.items()}
