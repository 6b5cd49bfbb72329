"""K2's merged adds on the CPU: ``cuda_bwd.plain_merged_bwd``, a plain model
of the kernel's img_grad summation (each (b, n, h) sums the terms of a
level's consecutive points on the same four pixels in f32 and adds each
run once, a run of two points or more exactly), against
``native_msda_backward`` and against JAX's ``pallas_msda_bwd`` in the
Pallas interpreter.

Tolerances, relative to max(1, |ref|):
  * f32 img_grad 1e-4 (the card's bar, ``chip_smoke.IMG_GRAD_TOL``): f32
    sums of f32 terms, against f64 (``native_msda_backward``) or JAX's
    exact kernel (``precision="highest"``);
  * bf16 img_grad 2e-2 (two ulps of the type, as on the card): the f32 sum
    is rounded to bf16 once on both sides;
  * the point and weight gradients are ``native_msda_backward``'s (K2 sums
    its corner dot products in f64 as it does), held equal to it and to
    JAX's exact kernel within 1e-4, the bar of ``test_torch_ops.py``.
"""

from itertools import product

import jax
import numpy as np
import pytest
import torch

from msda_tpu.ops.pallas_bwd import pallas_msda_bwd
from msda_tpu_torch.ops import native_msda_backward
from msda_tpu_torch.ops.cuda_bwd import plain_merged_bwd
from utils import get_functional_data

MODES = list(product(["border", "zeros"], [False, True]))
IMG_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
POINT_GRAD_TOL = 1e-4
ENCODER = ((100, 167), (50, 84), (25, 42), (13, 21))


def _err(got, want) -> float:
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1.0)).max().item()


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("merge", [True, False])
def test_plain_merged_matches_native(dtype, padding_mode, align_corners,
                                     merge):
    """83 queries with out-of-bounds points, every mode, f32 and bf16,
    merged and point by point."""
    img, shapes, pts, wts, og = get_functional_data(N=83, oob=True, seed=5)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    ti, tog = ti.to(dtype), tog.to(dtype)
    mode = (padding_mode, align_corners)
    got = plain_merged_bwd(ti, shapes, tp, tw, tog, *mode, merge=merge)
    want = native_msda_backward(ti, shapes, tp, tw, tog, *mode)
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    assert _err(got[0], want[0]) <= IMG_GRAD_TOL[dtype]
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_plain_merged_matches_pallas_interpret(padding_mode, align_corners):
    """f32 against JAX's exact K2 in the interpreter, 130 queries with
    out-of-bounds points."""
    img, shapes, pts, wts, og = get_functional_data(N=130, oob=True, seed=3)
    want = pallas_msda_bwd(img, shapes, pts, wts, og, padding_mode,
                           align_corners, precision="highest",
                           interpret=True)
    got = plain_merged_bwd(*_torch(img, shapes, pts, wts, og), padding_mode,
                           align_corners)
    for g, w, tol in zip(got, want, (IMG_GRAD_TOL[torch.float32],
                                     POINT_GRAD_TOL, POINT_GRAD_TOL)):
        assert _err(g, torch.from_numpy(np.array(w))) <= tol


def test_plain_merged_bf16_matches_pallas_interpret():
    """bf16 against JAX's single-pass bf16 K2 in the interpreter, both
    rounded to bf16: within 2e-2 on img_grad, and the point and weight
    gradients within JAX's own half-type bar (its G product is a bf16
    pass)."""
    img, shapes, pts, wts, og = get_functional_data(N=64, P=4, seed=4)
    bf = jax.numpy.bfloat16
    want = pallas_msda_bwd(jax.numpy.asarray(img, bf), shapes, pts, wts,
                           jax.numpy.asarray(og, bf), interpret=True)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    got = plain_merged_bwd(ti.bfloat16(), shapes, tp, tw, tog.bfloat16())
    w0 = torch.from_numpy(np.array(want[0], np.float32))
    assert _err(got[0], w0) <= IMG_GRAD_TOL[torch.bfloat16]
    for g, w in zip(got[1:], want[1:]):
        w = torch.from_numpy(np.array(w, np.float32))
        assert ((g - w).abs().max() / w.abs().max()).item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_plain_merged_with_every_point_at_one_place(dtype, padding_mode,
                                                    align_corners):
    """Every point of every (b, h) at one place on every level: a query's
    points on a level are one run."""
    img, shapes, pts, wts, og = get_functional_data(N=200, P=4, seed=6)
    pts = np.broadcast_to(np.float32([0.4, 0.6]), pts.shape).copy()
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    ti, tog = ti.to(dtype), tog.to(dtype)
    mode = (padding_mode, align_corners)
    got = plain_merged_bwd(ti, shapes, tp, tw, tog, *mode)
    want = native_msda_backward(ti, shapes, tp, tw, tog, *mode)
    assert want[0].float().abs().max() > 10  # the hot rows hold a (b, h)
    assert _err(got[0], want[0]) <= IMG_GRAD_TOL[dtype]
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("P", [2, 4])
def test_exact_runs_hold_the_bar_at_the_encoder_widths(P):
    """Deformable DETR's encoder pyramid, 22,223 queries of P points a
    level all at one place (22,223 P adds a corner a level point by
    point): with each query's run added exactly, img_grad is within 1e-5
    of max(1, |ref|), and ten times closer than one f32 add a point in the
    same sequential order."""
    rng = np.random.default_rng(7)
    B, N, H, C = 1, sum(h * w for h, w in ENCODER), 2, 8
    L = len(ENCODER)
    img = rng.standard_normal((B, N, H, C), dtype=np.float32)
    pts = np.broadcast_to(np.float32([0.37, 0.61]),
                          (B, N, H, L, P, 2)).copy()
    logits = rng.standard_normal((B, N, H, L * P), dtype=np.float32)
    wts = np.exp(logits - logits.max(-1, keepdims=True))
    wts = (wts / wts.sum(-1, keepdims=True)).reshape(B, N, H, L, P)
    og = rng.standard_normal((B, N, H, C), dtype=np.float32)
    args = _torch(img, ENCODER, pts, wts, og)
    want = native_msda_backward(*args)[0]
    merged = _err(plain_merged_bwd(*args)[0], want)
    pointwise = _err(plain_merged_bwd(*args, merge=False)[0], want)
    assert merged <= 1e-5
    assert merged <= pointwise / 10
