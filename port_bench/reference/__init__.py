"""The plain reference the benchmark decides ``correct`` against.

Plain PyTorch in float32, written from the published descriptions and
independent of the program: it imports neither ``jax``, nor the JAX
package, nor anything of ``pvr_habitat_tpu_torch``, and takes nothing
the program made.  It works out again what the program derives from the
benchmark's inputs (BatchNorm folding, the resize matrices, the
gathered unrolls, the recurrent state).  ``precision(tf32)`` sets the
one switch the control flips: TF32 off is the configurations' float32.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32=False):
    """float32 matmuls and convolutions in full precision (``tf32=False``)
    or in TF32, the control's precision; restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
