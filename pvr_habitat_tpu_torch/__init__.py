"""pvr_habitat_tpu_torch — the PyTorch / CUDA port of ``pvr_habitat_tpu``
for one NVIDIA H100.

It mirrors the JAX package's sub-packages and module names so that each
module's counterpart is found under the same path:

- ``models``    — primitives, the weight bridge, ResNets, the random
                  encoder, the encoder registry and ``EmbeddingNet``.
- ``ops``       — matmul-based image preprocessing, BN folding, and the
                  hand-written Hopper kernels under ``ops/cuda``.
- ``utils``     — device selection and the transfer pipeline.

The port imports torch and numpy, never jax nor the JAX package.  Every
entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
