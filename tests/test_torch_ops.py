"""The port's op (msda_tpu_torch.ops) against the JAX package on the CPU.

The same seeded numpy inputs (``tests/utils.get_functional_data``: P=3,
ragged N=130, out-of-bounds points in [-0.5, 1.5]) go through the JAX
reference, the JAX forward kernel K1 run by the Pallas interpreter, and the
port's plain version.  Tolerances: f32 1e-5 on the forward (both sides sum
in f32, in different orders), 1e-4 on f32 gradients (accumulated by
scatter-add over many points), f64 1e-8.
"""

from itertools import product

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from msda_tpu.ops import multiscale_deformable_attention as jax_msda  # noqa: E402
from msda_tpu.ops import native_multiscale_deformable_attention as jax_native  # noqa: E402
from msda_tpu.ops.pallas_fwd import pallas_multiscale_deformable_attention  # noqa: E402
from msda_tpu_torch.ops import (  # noqa: E402
    compute_level_data,
    level_shapes,
    multiscale_deformable_attention,
    native_multiscale_deformable_attention,
)
from msda_tpu_torch.ops import cuda_fwd  # noqa: E402
from msda_tpu_torch.ops.msda import _CudaMSDA  # noqa: E402
from utils import get_functional_data  # noqa: E402

MODES = list(product(["border", "zeros"], [False, True]))
FWD_TOL = {np.float32: 1e-5, np.float64: 1e-8}
GRAD_TOL = {np.float32: 1e-4, np.float64: 1e-8}


def _data(dtype):
    return get_functional_data(N=130, P=3, oob=True, dtype=dtype, seed=3)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_reference_matches_jax(dtype, padding_mode, align_corners):
    img, shapes, pts, wts, _ = _data(dtype)
    want = np.asarray(jax_native(img, shapes, pts, wts, padding_mode,
                                 align_corners))
    ti, tp, tw = _torch(img, pts, wts)
    got = multiscale_deformable_attention(
        ti, shapes, tp, tw, padding_mode, align_corners, impl="reference")
    assert got.dtype == ti.dtype
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_reference_matches_pallas_interpret(padding_mode, align_corners):
    """The port's plain version against K1 itself, run by the Pallas
    interpreter in exact f32 (precision="highest")."""
    img, shapes, pts, wts, _ = _data(np.float32)
    want = np.asarray(pallas_multiscale_deformable_attention(
        img, shapes, pts, wts, padding_mode, align_corners,
        precision="highest", interpret=True))
    ti, tp, tw = _torch(img, pts, wts)
    got = native_multiscale_deformable_attention(
        ti, shapes, tp, tw, padding_mode, align_corners)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_reference_gradients_match_jax_vjp(dtype, padding_mode,
                                           align_corners):
    img, shapes, pts, wts, og = _data(dtype)

    def f(i, p, w):
        return jax_msda(i, shapes, p, w, padding_mode, align_corners,
                        impl="reference")

    _, vjp = jax.vjp(f, img, pts, wts)
    want = [np.asarray(g) for g in vjp(og)]

    ti, tp, tw, tog = _torch(img, pts, wts, og)
    for t in (ti, tp, tw):
        t.requires_grad_(True)
    out = multiscale_deformable_attention(
        ti, shapes, tp, tw, padding_mode, align_corners, impl="reference")
    out.backward(tog)
    tol = GRAD_TOL[dtype]
    for name, t, w in zip(("img", "points", "weights"), (ti, tp, tw), want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=tol, rtol=tol,
                                   err_msg=f"{name} gradient")


def test_auto_on_cpu_is_reference():
    img, shapes, pts, wts, _ = _data(np.float32)
    ti, tp, tw = _torch(img, pts, wts)
    auto = multiscale_deformable_attention(ti, shapes, tp, tw)
    ref = native_multiscale_deformable_attention(ti, shapes, tp, tw)
    assert torch.equal(auto, ref)


@pytest.mark.parametrize("form", ["list", "numpy", "tensor", "tuple"])
def test_img_shapes_forms(form):
    img, shapes, pts, wts, _ = _data(np.float32)
    ti, tp, tw = _torch(img, pts, wts)
    arg = {
        "list": shapes.tolist(),
        "numpy": shapes,
        "tensor": torch.from_numpy(shapes),
        "tuple": tuple((int(h), int(w)) for h, w in shapes),
    }[form]
    assert level_shapes(arg) == tuple((int(h), int(w)) for h, w in shapes)
    out = multiscale_deformable_attention(ti, arg, tp, tw)
    ref = native_multiscale_deformable_attention(ti, shapes, tp, tw)
    assert torch.equal(out, ref)


def test_compute_level_data():
    h, w, offs = compute_level_data([(16, 16), (8, 4), (2, 3)])
    assert h.tolist() == [16.0, 8.0, 2.0]
    assert w.tolist() == [16.0, 4.0, 3.0]
    assert offs.tolist() == [0, 256, 288]


def _bad_inputs():
    img, shapes, pts, wts, _ = _data(np.float32)
    ti, tp, tw = _torch(img, pts, wts)
    return {
        "padding": dict(args=(ti, shapes, tp, tw), kw=dict(padding_mode="x"),
                        match="padding_mode"),
        "int_dtype": dict(args=(ti.to(torch.int32), shapes, tp, tw), kw={},
                          match="Dtype of `img`"),
        "img_rank": dict(args=(ti[0], shapes, tp, tw), kw={},
                         match="pixels|must be"),
        "shapes_rank": dict(args=(ti, shapes.reshape(-1), tp, tw), kw={},
                            match="img_shapes"),
        "pixel_count": dict(args=(ti[:, :-1], shapes, tp, tw), kw={},
                            match="pixels"),
        "levels": dict(args=(ti, shapes, tp[:, :, :, :2], tw[:, :, :, :2]),
                       kw={}, match=r"\[L, 2\]"),
        "points_rank": dict(args=(ti, shapes, tp[..., 0], tw), kw={},
                            match="sampling_points"),
        "weights_shape": dict(args=(ti, shapes, tp, tw[..., :1]), kw={},
                              match="attention_weights"),
        "batch_head": dict(args=(ti, shapes, tp[:, :, :1], tw[:, :, :1]),
                           kw={}, match="Batch/head"),
        "impl": dict(args=(ti, shapes, tp, tw), kw=dict(impl="pallas"),
                     match="impl"),
        "cuda_on_cpu": dict(args=(ti, shapes, tp, tw), kw=dict(impl="cuda"),
                            match="CUDA tensors"),
        "cuda_f64": dict(args=(ti.double(), shapes, tp, tw),
                         kw=dict(impl="cuda"), match="float64"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_validation_errors(case):
    c = _bad_inputs()[case]
    with pytest.raises(ValueError, match=c["match"]):
        multiscale_deformable_attention(*c["args"], **c["kw"])


def test_kernel_wrapper_rejects_cpu_tensors():
    img, shapes, pts, wts, _ = _data(np.float32)
    ti, tp, tw = _torch(img, pts, wts)
    before = cuda_fwd.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fwd.msda_fwd(ti, shapes, tp, tw)
    assert cuda_fwd.LAUNCHES == before


def test_cuda_backward_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="K2"):
        _CudaMSDA.backward(None, torch.zeros(1))
