"""The device mesh (counterpart of ``pvr_habitat_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ('data', 'model') mesh:
batches shard over 'data', and the policy's hidden and gate dims may
shard over 'model'.  In the port one process is one device, so the mesh
is the processes of ``torch.distributed`` (one, without a group), and
only its 'data' axis is ported: each rank takes its columns of the
batch, and the gradients and the BatchNorm statistics are summed over
the ranks (``train/bc_step.py``, ``models/policy.py``).  A 'model' axis
above 1 raises.
"""

from typing import NamedTuple

from pvr_habitat_tpu_torch.parallel import multihost

MODEL_AXIS_ITEM = "ROADMAP.md queue 1, item 3"


class Mesh(NamedTuple):
    data: int
    model: int

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
    ``n_devices`` defaults to the number of processes."""
    n = n_devices if n_devices is not None else multihost.world()[0]
    if shape is None:
        shape = (n, 1)
    shape = tuple(shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} != {n} devices")
    if shape[1] != 1:
        raise NotImplementedError(
            f"a 'model' mesh axis of {shape[1]} (tensor parallelism of the "
            f"policy) is not ported yet ({MODEL_AXIS_ITEM})")
    return Mesh(*shape)
