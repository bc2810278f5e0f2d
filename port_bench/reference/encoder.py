"""Frames to embeddings: the preprocess and the configuration's
encoder, in blocks of rows so that it fits beside what the run keeps."""

import torch

from port_bench.reference import preprocess, resnet, vit


@torch.no_grad()
def embed(frames, weights, enc, block=256):
    """frames: (N, H, W, 3) uint8 tensor on the device -> (N, out_size)
    float32."""
    forward = resnet.forward if enc["arch"] == "resnet" else vit.forward
    return torch.cat([forward(preprocess.preprocess(frames[i:i + block],
                                                    enc), weights, enc)
                      for i in range(0, frames.shape[0], block)])
