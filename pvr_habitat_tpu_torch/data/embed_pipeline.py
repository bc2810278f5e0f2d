"""Bulk embedding on one card (counterpart of
``pvr_habitat_tpu/data/embed_pipeline.py``): fixed-size batches of
frames stream through the preprocess and the frozen encoder, with the
upload of batch i+1, the compute of batch i and the download of batch
i-1 overlapped (``utils/pipeline.py``).

The encoder is an ``EmbeddingNet``: BN folded, its card default route
(``v1`` for a bottleneck ResNet, ``attention`` for MAE) chosen there.
``quantize=True`` serves it in W8A8 int8 (``ops/quantize.py``,
``models/registry.py::int8_serving_fns``) on that route where the int8
path has it, else ``off``: the activation scales calibrate on the first
batch, and the embeddings leave the card as bf16 (half the download),
made f32 on the host.  Otherwise the float path is ``EmbeddingNet``'s in
``compute_dtype``, with the params cast once to a bf16 ``compute_dtype``,
and returns f32.

The JAX package shards the batches over a device mesh; this port runs on
one card, and spreading it over several processes is ROADMAP.md queue 1,
item 7.
"""

import numpy as np
import torch

from pvr_habitat_tpu_torch.models.embedding_net import EmbeddingNet
from pvr_habitat_tpu_torch.models.registry import int8_serving_fns
from pvr_habitat_tpu_torch.utils.pipeline import pipelined_map


class ShardedEmbedder:
    def __init__(self, embedding_name, device=None, batch_size=256,
                 compute_dtype=torch.bfloat16, pretrained=True,
                 checkpoint_dir=None, run_id=0, quantize=False):
        self._int8 = int8_serving_fns(embedding_name) if quantize else None
        self.net = EmbeddingNet(
            embedding_name, pretrained=pretrained,
            checkpoint_dir=checkpoint_dir, run_id=run_id,
            compute_dtype=compute_dtype, device=device)
        self.device = self.net.device
        self.handle = self.net.handle
        self.out_size = self.net.out_size
        self.batch_size = max(batch_size, 1)
        self._scales = None
        if self._int8 is not None:
            self.params = self._int8.quantize_params(self.net.params)
            self.fused = (self.net.fused if self.net.fused
                          in self._int8.fused_routes else "off")
            return
        if compute_dtype == torch.bfloat16:
            self.net.params = {k: v.to(torch.bfloat16)
                               if v.dtype == torch.float32 else v
                               for k, v in self.net.params.items()}
        self.params = self.net.params
        self.fused = self.net.fused

    def _forward(self, frames):
        """One staged batch -> (batch, out_size): f32, or bf16 when int8."""
        if self._int8 is None:
            return self.net._forward(frames)
        with torch.inference_mode():
            x = self.handle.preprocess(frames, out_dtype=torch.bfloat16)
            if self._scales is None:
                _, scales = self._int8.apply(self.params, x, None,
                                             fused=self.fused)
                self._scales = {k: float(v) for k, v in scales.items()}
            out, _ = self._int8.apply(self.params, x, self._scales,
                                      fused=self.fused)
            return out.reshape(out.shape[0], -1).to(torch.bfloat16)

    def _stage(self, chunk):
        if chunk.shape[0] < self.batch_size:     # pad the ragged tail
            pad = np.zeros(
                (self.batch_size - chunk.shape[0],) + chunk.shape[1:],
                chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        return torch.as_tensor(chunk).to(self.device)

    def embed_all(self, frames):
        """frames: (N, H, W, 3) uint8 host array -> (N, out_size) f32."""
        n = frames.shape[0]
        bs = self.batch_size
        results = pipelined_map(
            range(0, n, bs),
            stage=lambda i: self._stage(frames[i:i + bs]),
            dispatch=self._forward,
            fetch=lambda out: out.cpu().float().numpy())
        if not results:
            return np.zeros((0, self.out_size), np.float32)
        return np.concatenate(results)[:n]

    def embed_local(self, frames):
        """This process's slice of a dataset -> its embeddings.  One
        process embeds everything; several are not ported yet."""
        if torch.distributed.is_available() \
                and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "multi-process bulk embedding is not ported yet "
                "(ROADMAP.md queue 1, item 7)")
        return self.embed_all(frames)
