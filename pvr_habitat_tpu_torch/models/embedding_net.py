"""EmbeddingNet — the encoder runtime (counterpart of
``pvr_habitat_tpu/models/embedding_net.py``; reference:
src/embeddings.py:339-402).

Input: (N, H, W, 3) uint8 NHWC frames.  Output: (N, out_size).  One
forward runs the preprocess and the encoder on the device; eval mode
returns numpy squeezed like the reference, train mode a tensor.

``fused`` picks the route of a bottleneck ResNet's blocks: ``off``
(``F.conv2d``), ``v1``, ``v2`` or ``hybrid`` (the Hopper kernels of
``ops/cuda/fused_bottleneck.py``).  On the card a frozen bottleneck net
defaults to ``v1``, which runs every block of ResNet-50 through the
kernel; on the CPU the default is ``off``, since there the kernels'
plain versions only repeat the conv path's work.  PyTorch runs eagerly,
so the JAX package's power-of-two batch padding, which bounded its jit
cache, is gone; the results are the same.
"""

import numpy as np
import torch

from pvr_habitat_tpu_torch.models import convert
from pvr_habitat_tpu_torch.models.registry import build_encoder
from pvr_habitat_tpu_torch.ops.fold_bn import fold_resnet_bn
from pvr_habitat_tpu_torch.utils.pipeline import pipelined_map
from pvr_habitat_tpu_torch.utils.platform import resolve_device


class EmbeddingNet:
    def __init__(self, embedding_name, in_channels=3, pretrained=True,
                 train=False, checkpoint_dir=None, run_id=0,
                 compute_dtype=torch.float32, max_bucket=1024, device=None,
                 fused=None):
        if in_channels != 3:
            raise ValueError("Current models accept 3-channel inputs only.")
        self.device = resolve_device(device)
        self.embedding_name = embedding_name
        self.training = train
        self.compute_dtype = compute_dtype
        self.max_bucket = max_bucket

        self.handle = build_encoder(
            embedding_name, pretrained=pretrained,
            checkpoint_dir=checkpoint_dir, run_id=run_id, device=self.device)
        self.params = self.handle.params
        if not train and any(k.endswith(".running_mean")
                             for k in self.params):
            # Frozen encoder: fold BN into the convs (idempotent; the
            # apply fns run unchanged on folded params).
            self.params = fold_resnet_bn(self.params)
        self.out_size = self.handle.out_size

        routes = self.handle.fused_routes
        if fused is None:
            fused = "v1" if (self.device.type == "cuda" and not train
                             and "v1" in routes) else "off"
        if fused not in routes or (train and fused != "off"):
            raise ValueError(f"fused={fused!r} not available for "
                             f"'{embedding_name}' (train={train}); "
                             f"routes: {routes}")
        self.fused = fused

    # -- functional path -----------------------------------------------------

    def apply(self, params, frames):
        """frames: uint8 tensor on ``self.device`` -> (N, out_size) f32."""
        x = self.handle.preprocess(frames, out_dtype=self.compute_dtype)
        if self.fused == "off":
            out = self.handle.apply_fn(params, x, train=self.training)
        else:
            out = self.handle.apply_fn(params, x, fused=self.fused)
        return out.reshape(out.shape[0], -1).float()

    def _forward(self, frames):
        with torch.inference_mode(not self.training):
            return self.apply(self.params, frames)

    def _upload(self, frames):
        return torch.as_tensor(np.asarray(frames)).to(self.device)

    # -- serving path -----------------------------------------------------------

    def __call__(self, observation):
        """observation: (N, H, W, 3) uint8 (numpy or tensor).

        Eval: numpy (N, out_size), squeezed like the reference
        (src/embeddings.py:402).  Train: a tensor.
        """
        if self.embedding_name == "true_state":
            return np.squeeze(np.asarray(observation))
        frames = self._upload(observation)
        out = torch.cat([self._forward(frames[i:i + self.max_bucket])
                         for i in range(0, frames.shape[0], self.max_bucket)])
        if self.training:
            return out.squeeze()
        return out.cpu().numpy().squeeze()

    def embed_batches(self, frames, batch_size):
        """Bulk path (the main_bc_1 embed-at-load hot loop, reference
        main_bc_1.py:127-138): upload, compute and download overlap via
        the three-stage pipeline in utils/pipeline.py."""
        if self.embedding_name == "true_state":
            return np.squeeze(np.asarray(frames))
        n = frames.shape[0]
        results = pipelined_map(
            range(0, n, batch_size),
            stage=lambda i: self._upload(frames[i:i + batch_size]),
            dispatch=self._forward,
            fetch=lambda out: out.cpu().numpy())
        if not results:
            return np.zeros((0, self.out_size), np.float32)
        return np.concatenate(results, axis=0)

    # -- persistence (keeps the '{embedding}.tar' contract) ------------------

    def save(self, path):
        convert.save_flat(path, self.params,
                          extra={"embedding_name": self.embedding_name})

    def load(self, path):
        self.params = convert.load_flat(path, self.device)
