"""pvr_habitat_tpu_torch — the PyTorch / CUDA port of ``pvr_habitat_tpu``
for one NVIDIA H100.

It mirrors the JAX package's sub-packages and module names so that each
module's counterpart is found under the same path:

- ``models``    — primitives, the weight bridge, ResNets, ViTs, the random
                  encoder, the encoder registry, ``EmbeddingNet`` and the
                  BC policy.
- ``ops``       — matmul-based image preprocessing, BN folding, the
                  done-masked LSTM, and the hand-written Hopper kernels
                  under ``ops/cuda``.
- ``envs``      — the FakeNav simulator and the wrapper stack (numpy
                  copies of the JAX package's).
- ``data``      — the pickle dataset formats and the unroll sampler.
- ``train``     — the optimizer, the train step, the trainer and online
                  evaluation.
- ``utils``     — device selection, flags, stats, checkpoints, profiling
                  and the transfer pipeline.
- ``tools``     — datagen, bulk embedding and kernel-variant timing.

The CLIs are ``python -m pvr_habitat_tpu_torch.main_bc_2`` (BC on
precomputed embeddings), ``.main_bc_1`` (embed at load) and
``.main_test`` (evaluate a checkpoint).  The port imports torch and
numpy, never jax nor the JAX package.  Every entry point runs on
``cuda`` unless the caller passes ``device="cpu"`` or ``--disable_cuda``.
"""
