"""The Hopper fused-bottleneck kernels vs. their plain PyTorch versions,
on the card.  Imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from pvr_habitat_tpu_torch.models import resnet
from pvr_habitat_tpu_torch.ops.cuda import fused_bottleneck as fb
from pvr_habitat_tpu_torch.ops.fold_bn import fold_resnet_bn

# f32 with TF32 off: only the summation order differs.  bf16: y1 and y2
# are rounded at the same points, but a sum that lands at a rounding
# boundary may round the other way in one of the two.
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _block(rng, cin, planes, stride, dtype):
    params = {}
    resnet._init_bottleneck(params, rng, "b", cin, planes, stride)
    for key in list(params):
        if key.endswith(".bias") and "downsample" not in key:
            params[key] = rng.randn(*np.shape(params[key])).astype(np.float32)
    params = fold_resnet_bn({k: torch.from_numpy(v).cuda()
                             for k, v in params.items()})
    return fb.block_weights(params, "b", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,cin,planes,h", [
    (1, 64, 32, 16), (1, 128, 32, 16), (2, 128, 64, 16), (1, 64, 16, 7)])
def test_kernels_match_plain_versions(dtype, stride, cin, planes, h):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(7)
    w = _block(rng, cin, planes, stride, dtype)
    x = torch.from_numpy(rng.randn(2, h, h, cin).astype(np.float32))
    x = x.to("cuda", dtype)
    before = dict(fb.launches)
    got = fb.fused_bottleneck(x, *w, stride=stride).float()
    want = fb.fused_bottleneck_ref(x, *w, stride=stride).float()
    torch.cuda.synchronize()
    assert fb.launches["fused_bottleneck"] == before["fused_bottleneck"] + 1
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    if stride == 1:
        mask = torch.from_numpy(fb.flat_mask(h, h)).cuda()
        xf = fb.to_padded_flat(x)
        got = fb.fused_bottleneck_flat(xf, mask, *w, h=h, w=h).float()
        want = fb.fused_bottleneck_flat_ref(xf, mask, *w, h=h, w=h).float()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
