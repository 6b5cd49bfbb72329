"""The port's CUDA kernels (K1 forward, K2 backward) against their plain
versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them:
the kernel has no CPU mode.  The file imports no JAX, so it runs on a
machine with the card and PyTorch only:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)

Tolerances, relative to max(1, |ref|): K1 f32 1e-5 (both sum in f32, in
different orders); bf16 2e-2 and f16 2e-3, about two ulps of the output type,
since both round an f32 sum once.  K2: the point and weight gradients 1e-4 in
every dtype (both compute the point gradients exactly, with f64 channel sums,
on the same f32 geometry; the weight gradients are f32 sums over channels, in
different orders); img_grad f32 1e-4 (f32 atomic sums in run-dependent
order), bf16 2e-2 and f16 2e-3 (both round an f32 sum once).
"""

from itertools import product

import numpy as np
import pytest
import torch

from msda_tpu_torch.models import DeformableDetr, init_parameters
from msda_tpu_torch.ops import (
    multiscale_deformable_attention,
    native_msda_backward,
    native_multiscale_deformable_attention,
)
from msda_tpu_torch.ops import cuda_bwd, cuda_fwd
from msda_tpu_torch.parallel import detection_loss
from utils import get_functional_data

pytestmark = pytest.mark.cuda

MODES = list(product(["border", "zeros"], [False, True]))
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
IMG_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
                torch.float16: 2e-3}
POINT_GRAD_TOL = 1e-4
CFGS = [
    dict(N=130, P=3),          # ragged N, P not a power of two
    dict(N=37, C=48, P=9),     # C past one warp, L*P = 36 past one warp
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, with_grad=False, **cfg):
    img, shapes, pts, wts, og = get_functional_data(oob=True, seed=5, **cfg)
    img = torch.from_numpy(img).to(device=device, dtype=dtype)
    pts = torch.from_numpy(pts).to(device)
    wts = torch.from_numpy(wts).to(device)
    if with_grad:
        return img, shapes, pts, wts, torch.from_numpy(og).to(device, dtype)
    return img, shapes, pts, wts


def _check(got, want, dtype, tol=None):
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape
    tol = TOL[dtype] if tol is None else tol
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= tol, f"max error {err} > {tol}"


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("cfg", CFGS)
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


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("cfg", CFGS)
def test_backward_kernel_matches_plain(device, dtype, padding_mode,
                                       align_corners, cfg):
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True, **cfg)
    before = cuda_bwd.LAUNCHES
    got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og, padding_mode,
                            align_corners)
    torch.cuda.synchronize()
    assert cuda_bwd.LAUNCHES == before + 1
    want = native_msda_backward(img, shapes, pts, wts, og, padding_mode,
                                align_corners)
    _check(got[0], want[0], dtype, IMG_GRAD_TOL[dtype])
    _check(got[1], want[1], torch.float32, POINT_GRAD_TOL)
    _check(got[2], want[2], torch.float32, POINT_GRAD_TOL)


def test_auto_backward_launches_the_backward_kernel_once(device):
    img, shapes, pts, wts, og = _inputs(device, torch.float32, with_grad=True,
                                        N=50)
    leaves = [t.clone().requires_grad_(True) for t in (img, pts, wts)]
    fwd, bwd = cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES
    out = multiscale_deformable_attention(leaves[0], shapes, *leaves[1:])
    out.backward(og)
    assert (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES) == (fwd + 1, bwd + 1)
    want = native_msda_backward(img, shapes, pts, wts, og)
    for leaf, w in zip(leaves, want):
        _check(leaf.grad, w, torch.float32, POINT_GRAD_TOL)


def test_double_backward_raises(device):
    img, shapes, pts, wts = _inputs(device, torch.float32, N=20)
    pts.requires_grad_(True)
    out = multiscale_deformable_attention(img, shapes, pts, wts, impl="cuda")
    (g,) = torch.autograd.grad(out.square().sum(), pts, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(device):
    img, shapes, pts, wts, og = _inputs(device, torch.float32, with_grad=True,
                                        N=20)
    before = cuda_bwd.LAUNCHES
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        cuda_bwd.msda_bwd(img.double(), shapes, pts, wts, og.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts,
                          og.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_bwd.msda_bwd(img.cpu(), shapes, pts, wts, og)
    with pytest.raises(ValueError, match="dtype and device"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts, og.cpu())
    with pytest.raises(ValueError, match="dtype and device"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts, og.half())
    with pytest.raises(ValueError, match="out_grad must be"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts, og[:, :-1].contiguous())
    with pytest.raises(ValueError, match="shape mismatch"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts[..., :1].contiguous(), og)
    assert cuda_bwd.LAUNCHES == before


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


LEVELS = [(16, 16), (8, 8), (4, 4), (2, 2)]


def _small_model(device, impl):
    model = DeformableDetr(num_classes=8, in_channels=[32] * 4, emb_dim=64,
                           num_heads=4, num_points=2, num_queries=16,
                           ffn_dim=128, with_box_refinement=True, impl=impl,
                           device=device)
    return init_parameters(model, torch.Generator().manual_seed(0))


def _small_pyramid(device):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(
        rng.standard_normal((2, h, w, 32)).astype(np.float32)).to(device)
        for h, w in LEVELS]


def test_small_model_cuda_matches_reference(device):
    pyramid = _small_pyramid(device)
    outs = {}
    for impl in ("cuda", "reference"):
        with torch.inference_mode():
            outs[impl] = _small_model(device, impl)(pyramid, LEVELS)
    for k in ("logits", "boxes"):
        np.testing.assert_allclose(outs["cuda"][k].cpu().numpy(),
                                   outs["reference"][k].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_small_model_gradients_cuda_match_reference(device):
    """Every parameter's gradient through the detection loss, within 1e-4
    of the tensor's largest gradient, that scale being at least 1e-3 of the
    model's largest gradient (the self-attention key bias has a gradient
    that is zero in exact arithmetic, so it holds rounding noise only)."""
    pyramid = _small_pyramid(device)
    rng = np.random.default_rng(1)
    targets = {
        "labels": torch.from_numpy(rng.integers(0, 8, (2, 5))).to(device),
        "boxes": torch.from_numpy(
            rng.uniform(0.2, 0.6, (2, 5, 4)).astype(np.float32)).to(device),
        "mask": torch.ones(2, 5, device=device),
    }
    grads, losses = {}, {}
    for impl in ("cuda", "reference"):
        model = _small_model(device, impl)
        before = cuda_bwd.LAUNCHES
        loss = detection_loss(model(pyramid, LEVELS), targets,
                              class_loss="focal")
        loss.backward()
        assert cuda_bwd.LAUNCHES - before == (4 if impl == "cuda" else 0)
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
    assert losses["cuda"] == pytest.approx(losses["reference"], rel=1e-5)
    floor = 1e-3 * max(w.abs().max().item()
                       for w in grads["reference"].values())
    for name, want in grads["reference"].items():
        got = grads["cuda"][name]
        scale = max(want.abs().max().item(), floor)
        err = (got - want).abs().max().item() / scale
        assert err <= 1e-4, f"{name}: {err}"
