"""Bulk embedder (counterpart of
``pvr_habitat_tpu/tools/save_embedded_obs.py``; reference:
behavioral_cloning/save_embedded_obs.py:96-177): pass recorded
frames through a frozen encoder on the card and cache the embeddings.

    python -m pvr_habitat_tpu_torch.tools.save_embedded_obs \\
        --env FakePointNav-apartment_0 --embedding_name resnet50 \\
        --source pickle --data_path DIR [--disable_cuda]

Idempotent: returns immediately when the output pickle exists.  Also
persists the encoder weights as '{data_path}/{embedding}[_runid].tar'
(the reference's contract, save_embedded_obs.py:126-131).  Frames come
from the raw trajectory pickle (``--source pickle``) and stream through
``EmbeddingNet.embed_batches``, or with ``--sharded_embed`` through
``data/embed_pipeline.py::ShardedEmbedder`` on one card;
``--quantize_embed`` serves the encoder in W8A8 int8 there:

    python -m pvr_habitat_tpu_torch.tools.save_embedded_obs \\
        --env FakePointNav-apartment_0 --embedding_name resnet50 \\
        --source pickle --data_path DIR --quantize_embed

The PNG source and a ``--mesh_shape`` of more than one device are not
ported yet and raise.
"""

import os
import random

import numpy as np

from pvr_habitat_tpu_torch.data import formats
from pvr_habitat_tpu_torch.data.embed_pipeline import ShardedEmbedder
from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.train.bc import (check_single_device,
                                            compute_dtype,
                                            embed_in_minibatches,
                                            flags_device)
from pvr_habitat_tpu_torch.utils.flags import build_parser


def run(flags):
    if flags.source == "png":
        raise NotImplementedError(
            "--source png is not ported yet (ROADMAP.md queue 1, item 3)")
    check_single_device(flags)
    save_name = formats.embedded_path(flags.data_path, flags.env,
                                      flags.embedding_name)
    if os.path.isfile(save_name):
        return save_name

    device = flags_device(flags)
    np.random.seed(flags.run_id)
    random.seed(flags.run_id)

    embedding_model = EmbeddingNet(
        flags.embedding_name, in_channels=3,
        pretrained=flags.pretrained_embedding,
        train=flags.train_embedding,
        checkpoint_dir=flags.data_path, run_id=flags.run_id,
        compute_dtype=compute_dtype(flags), device=device)

    # Save the encoder weights used (random gets a per-run suffix).
    emb_path = os.path.join(flags.data_path, flags.embedding_name)
    if flags.embedding_name == "random":
        emb_path += "_" + str(flags.run_id)
    embedding_model.save(emb_path + ".tar")

    print("=== Loading trajectories ===")
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
    assert n > 0, "no data found"
    print("   total number of samples", n)

    formats.save_embedded(save_name, obs, data["action"][:n],
                          data["reward"][:n], data["done"][:n],
                          data["true_state"][:n])
    return save_name


def _embed_sharded(flags, device, frames, batch_size):
    """The ``ShardedEmbedder`` path (``--sharded_embed``,
    ``--quantize_embed``) on one card."""
    embedder = ShardedEmbedder(
        flags.embedding_name, device=device, batch_size=batch_size,
        compute_dtype=compute_dtype(flags),
        pretrained=flags.pretrained_embedding,
        checkpoint_dir=flags.data_path, run_id=flags.run_id,
        quantize=flags.quantize_embed)
    return embedder.embed_all(np.asarray(frames))


def build_tool_parser():
    parser = build_parser()
    parser.add_argument("--n_trajectories", type=int, default=-1)
    parser.add_argument("--source", type=str, default="png",
                        choices=["png", "pickle"])
    parser.add_argument("--sharded_embed", action="store_true",
                        help="Embed via the bulk pipeline "
                             "(data/embed_pipeline.py) on one card; a "
                             "mesh of several devices is not ported yet.")
    parser.add_argument("--quantize_embed", action="store_true",
                        help="W8A8 int8 serving for the ResNet families, "
                             "clip_rn50, maskrcnn_l3 and the MAE ViTs "
                             "(cosine-gated against f32 in "
                             "tests/test_torch_quantize.py). Implies the "
                             "bulk pipeline.")
    return parser


if __name__ == "__main__":
    run(build_tool_parser().parse_args())
