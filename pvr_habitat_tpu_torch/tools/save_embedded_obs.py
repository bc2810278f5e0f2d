"""Bulk embedder (counterpart of
``pvr_habitat_tpu/tools/save_embedded_obs.py``; reference:
behavioral_cloning/save_embedded_obs.py:96-177): pass recorded
frames through a frozen encoder on the card and cache the embeddings.

    python -m pvr_habitat_tpu_torch.tools.save_embedded_obs \\
        --env FakePointNav-apartment_0 --embedding_name resnet50 \\
        --data_path DIR [--disable_cuda]

Idempotent: returns immediately when the output pickle exists.  Also
persists the encoder weights as '{data_path}/{embedding}[_runid].tar'
(the reference's contract, save_embedded_obs.py:126-131).  Frames come
from the PNG layout '{data_path}/{env}/' (``--source png``, the default;
each trajectory is embedded as it is read, its decode overlapped with
the previous one's embedding) or from the raw trajectory pickle
(``--source pickle``), which streams through
``EmbeddingNet.embed_batches``, or with ``--sharded_embed`` through
``data/embed_pipeline.py::ShardedEmbedder``; ``--quantize_embed`` serves
the encoder in W8A8 int8 there:

    python -m pvr_habitat_tpu_torch.tools.save_embedded_obs \\
        --env FakePointNav-apartment_0 --embedding_name resnet50 \\
        --source pickle --data_path DIR --quantize_embed

With ``--coordinator host:port --num_processes d --process_id i`` the run
is one rank of d (``parallel/multihost.py``): under ``--sharded_embed``
each rank embeds its slice of the frames and the slices are gathered;
rank 0 alone writes, and every rank waits for it at a barrier.
"""

import os
import random

import numpy as np

from pvr_habitat_tpu_torch.data import formats
from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.parallel import mesh as pmesh
from pvr_habitat_tpu_torch.parallel import multihost
from pvr_habitat_tpu_torch.train.bc import (compute_dtype,
                                            embed_in_minibatches,
                                            flags_device)
from pvr_habitat_tpu_torch.utils.flags import build_parser


def run(flags):
    save_name = formats.embedded_path(flags.data_path, flags.env,
                                      flags.embedding_name)
    if os.path.isfile(save_name):
        return save_name
    with multihost.session(flags, flags_device(flags)) as device:
        _check_mesh(flags)
        _run(flags, device, save_name)
        # Non-writer ranks must not return (and read save_name, or leave
        # the group) while rank 0 is still writing.
        multihost.barrier()
    return save_name


def _check_mesh(flags):
    """Embedding splits the frames over every process, whatever the
    mesh's axes; a ``--mesh_shape`` names at most that many devices."""
    shape = pmesh.parse_mesh_shape(flags.mesh_shape)
    if shape is None:
        return
    size = multihost.world()[0]
    want = shape[0] * shape[1]
    if want > size:
        raise ValueError(f"mesh {shape} needs {want} devices, have {size}")


def _run(flags, device, save_name):
    np.random.seed(flags.run_id)
    random.seed(flags.run_id)

    embedding_model = EmbeddingNet(
        flags.embedding_name, in_channels=3,
        pretrained=flags.pretrained_embedding,
        train=flags.train_embedding,
        checkpoint_dir=flags.data_path, run_id=flags.run_id,
        compute_dtype=compute_dtype(flags), device=device)

    # Save the encoder weights used (random gets a per-run suffix).
    # Several processes: all compute, only rank 0 writes (concurrent
    # writers on the shared data_path would corrupt the files).
    is_writer = multihost.world()[1] == 0
    emb_path = os.path.join(flags.data_path, flags.embedding_name)
    if flags.embedding_name == "random":
        emb_path += "_" + str(flags.run_id)
    if is_writer:
        embedding_model.save(emb_path + ".tar")

    print("=== Loading trajectories ===")
    if flags.source == "png":
        data = formats.read_png_trajectories(
            os.path.join(flags.data_path, flags.env),
            embed_fn=embedding_model,
            n_trajectories=flags.n_trajectories)
    else:
        data = formats.read_habitat_data(
            formats.raw_path(flags.data_path, flags.env),
            n_trajectories=flags.n_trajectories)
        print("   passing observations through embedding model")
        batch = flags.embed_batch_size or flags.batch_size
        if flags.sharded_embed or flags.quantize_embed:
            obs = _embed_sharded(flags, device, data["obs"], batch)
        else:
            obs = embed_in_minibatches(embedding_model, data["obs"], batch)
        n = obs.shape[0]
        data = dict(obs=obs, action=data["action"][:n],
                    reward=data["reward"][:n], done=data["done"][:n],
                    true_state=data["true_state"][:n])

    n_samples = len(data["reward"])
    assert n_samples > 0, "no data found"
    print("   total number of samples", n_samples)
    if is_writer:
        formats.save_embedded(save_name, data["obs"], data["action"],
                              data["reward"], data["done"],
                              data["true_state"])


def _embed_sharded(flags, device, frames, batch_size):
    """The ``ShardedEmbedder`` path (``--sharded_embed``,
    ``--quantize_embed``): each process embeds its ``process_slice`` of
    the frames, and the ragged slices are gathered in rank order."""
    embedder = ShardedEmbedder(
        flags.embedding_name, device=device, batch_size=batch_size,
        compute_dtype=compute_dtype(flags),
        pretrained=flags.pretrained_embedding,
        checkpoint_dir=flags.data_path, run_id=flags.run_id,
        quantize=flags.quantize_embed)
    frames = np.asarray(frames)
    start, stop = multihost.process_slice(frames.shape[0])
    return multihost.allgather_rows(embedder.embed_local(frames[start:stop]))


def build_tool_parser():
    parser = build_parser()
    parser.add_argument("--n_trajectories", type=int, default=-1)
    parser.add_argument("--source", type=str, default="png",
                        choices=["png", "pickle"])
    parser.add_argument("--sharded_embed", action="store_true",
                        help="Embed via the bulk pipeline "
                             "(data/embed_pipeline.py); with --coordinator, "
                             "each process embeds its slice of the dataset.")
    parser.add_argument("--quantize_embed", action="store_true",
                        help="W8A8 int8 serving for the ResNet families, "
                             "clip_rn50, maskrcnn_l3 and the MAE ViTs "
                             "(cosine-gated against f32 in "
                             "tests/test_torch_quantize.py). Implies the "
                             "bulk pipeline.")
    return parser


if __name__ == "__main__":
    run(build_tool_parser().parse_args())
