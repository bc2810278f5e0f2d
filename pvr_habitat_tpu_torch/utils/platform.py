"""Device selection for every entry point of the port.

The rule: work runs on the card unless the caller asks for the CPU.
``resolve_device(None)`` returns ``cuda`` and raises when CUDA is
missing; it never falls back to the CPU on its own.

The float32 parity path must not run in TF32.  PyTorch runs float32
matmuls in full precision by default but float32 convolutions through
cuDNN in TF32, which keeps about three decimal digits and would break
the 1e-3 parity contract with the JAX package.  ``ALLOW_TF32`` states
the setting once; ``resolve_device`` applies it whenever it hands out a
CUDA device.
"""

import torch

ALLOW_TF32 = False


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without CUDA); ``"cpu"`` only when
    asked for.  Returns a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the "
                "CPU explicitly")
        torch.backends.cudnn.allow_tf32 = ALLOW_TF32
        torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    return dev
