"""Port fused attention vs. the JAX package's Pallas kernel in interpret
mode (CPU).  The Hopper kernel itself is held against this plain version
in tests/test_torch_cuda_kernels.py, on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pvr_habitat_tpu.ops.pallas import attention as jattn
from pvr_habitat_tpu_torch.ops.cuda import attention as tattn

# f32: the JAX test's own tolerance (tests/test_fused_attention.py).
# bf16: both versions round p and the output to bf16 at the same points;
# a sum that lands on a rounding boundary in one of them moves the output
# by one bf16 ulp, 2^-8 of its magnitude (below 2e-3 here, |out| < 0.8).
TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 17, 16), "float32"),      # the JAX test's ragged shape
    ((2, 3, 197, 32), "float32"),     # MAE's L
    ((2, 4, 197, 64), "bfloat16"),    # mae_base heads, the serving dtype
])
def test_plain_version_matches_pallas(shape, dtype):
    arrays = _qkv(shape, seed=0)
    want = jattn.fused_attention(
        *(jnp.asarray(a, dtype) for a in arrays), interpret=True)
    got = tattn.fused_attention_ref(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=tol, rtol=0 if dtype == "bfloat16" else tol)


def test_cpu_wrapper_runs_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, 20, 16), seed=1))
    before = dict(tattn.launches)
    got = tattn.fused_attention(q, k, v)
    torch.testing.assert_close(got, tattn.fused_attention_ref(q, k, v),
                               atol=0, rtol=0)
    assert tattn.launches == before


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.fused_attention(q, q, q)


@pytest.mark.parametrize("dtype,length,applies", [
    (torch.bfloat16, 197, True),     # MAE base / large
    (torch.bfloat16, 257, True),     # MAE huge
    (torch.bfloat16, 128, True),
    (torch.bfloat16, 127, False),
    (torch.bfloat16, 50, False),     # CLIP ViT-B/32
    (torch.float32, 197, False),     # the f32 parity path
])
def test_kernel_applies_follows_the_jax_condition(dtype, length, applies):
    assert tattn.kernel_applies(dtype, length) is applies
