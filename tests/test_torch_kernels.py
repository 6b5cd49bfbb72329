"""The port's CUDA forward kernel (K1) against its plain version, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them:
the kernel has no CPU mode.  The file imports no JAX, so it runs on a
machine with the card and PyTorch only:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)

Tolerances: f32 1e-5 (both sum in f32, in different orders); bf16 2e-2 and
f16 2e-3 relative to max(1, |ref|), about two ulps of the output type, since
both round an f32 sum once.
"""

from itertools import product

import numpy as np
import pytest
import torch

from msda_tpu_torch.models import DeformableDetr, init_parameters
from msda_tpu_torch.ops import (
    multiscale_deformable_attention,
    native_multiscale_deformable_attention,
)
from msda_tpu_torch.ops import cuda_fwd
from utils import get_functional_data

pytestmark = pytest.mark.cuda

MODES = list(product(["border", "zeros"], [False, True]))
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, **cfg):
    img, shapes, pts, wts, _ = get_functional_data(oob=True, seed=5, **cfg)
    img = torch.from_numpy(img).to(device=device, dtype=dtype)
    pts = torch.from_numpy(pts).to(device)
    wts = torch.from_numpy(wts).to(device)
    return img, shapes, pts, wts


def _check(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[dtype], f"max error {err} > {TOL[dtype]}"


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("cfg", [
    dict(N=130, P=3),          # ragged N, P not a power of two
    dict(N=37, C=48, P=9),     # C past one warp, L*P = 36 past one warp
])
def test_kernel_matches_plain(device, dtype, padding_mode, align_corners,
                              cfg):
    img, shapes, pts, wts = _inputs(device, dtype, **cfg)
    before = cuda_fwd.LAUNCHES
    got = cuda_fwd.msda_fwd(img, shapes, pts, wts, padding_mode,
                            align_corners)
    torch.cuda.synchronize()
    assert cuda_fwd.LAUNCHES == before + 1
    want = native_multiscale_deformable_attention(
        img, shapes, pts, wts, padding_mode, align_corners)
    _check(got, want, dtype)


def test_auto_routes_cuda_tensors_to_the_kernel(device):
    img, shapes, pts, wts = _inputs(device, torch.float32, N=50)
    before = cuda_fwd.LAUNCHES
    out = multiscale_deformable_attention(img, shapes, pts, wts)
    assert cuda_fwd.LAUNCHES == before + 1
    ref = multiscale_deformable_attention(img, shapes, pts, wts,
                                          impl="reference")
    assert cuda_fwd.LAUNCHES == before + 1
    _check(out, ref, torch.float32)


def test_backward_through_the_kernel_raises(device):
    img, shapes, pts, wts = _inputs(device, torch.float32, N=20)
    img.requires_grad_(True)
    out = multiscale_deformable_attention(img, shapes, pts, wts, impl="cuda")
    with pytest.raises(NotImplementedError, match="K2"):
        out.sum().backward()


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    img, shapes, pts, wts = _inputs(device, torch.float32, N=20)
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        cuda_fwd.msda_fwd(img.double(), shapes, pts, wts)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fwd.msda_fwd(img.transpose(1, 2).contiguous().transpose(1, 2),
                          shapes, pts, wts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fwd.msda_fwd(img, shapes, pts.cpu(), wts)
    with pytest.raises(ValueError, match="pixels"):
        cuda_fwd.msda_fwd(img[:, 1:].contiguous(), shapes, pts, wts)


def test_small_model_cuda_matches_reference(device):
    levels = [(16, 16), (8, 8), (4, 4), (2, 2)]
    rng = np.random.default_rng(0)
    pyramid = [torch.from_numpy(
        rng.standard_normal((2, h, w, 32)).astype(np.float32)).to(device)
        for h, w in levels]
    outs = {}
    for impl in ("cuda", "reference"):
        model = DeformableDetr(num_classes=8, in_channels=[32] * 4,
                               emb_dim=64, num_heads=4, num_points=2,
                               num_queries=16, ffn_dim=128,
                               with_box_refinement=True, impl=impl,
                               device=device)
        init_parameters(model, torch.Generator().manual_seed(0))
        with torch.inference_mode():
            outs[impl] = model(pyramid, levels)
    for k in ("logits", "boxes"):
        np.testing.assert_allclose(outs["cuda"][k].cpu().numpy(),
                                   outs["reference"][k].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
