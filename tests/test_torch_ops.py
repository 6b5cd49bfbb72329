"""The port's op (msda_tpu_torch.ops) against the JAX package on the CPU.

The same seeded numpy inputs (``tests/utils.get_functional_data``: P=3,
ragged N=130, out-of-bounds points in [-0.5, 1.5]) go through the JAX
reference, the JAX kernels K1 (forward) and K2 (backward) run by the Pallas
interpreter, the torch ``grid_sample`` oracle (``tests/oracle.py``), and the
port's plain versions.  K6, the round-4 pipelined forward
(``docs/experiments/exp_fwd_pipeline_r4.py``), computes K1's function; it is
held against the port's plain forward too.  Tolerances: f32 1e-5 on the
forward (both sides sum in f32, in different orders), 1e-4 on f32 gradients
(accumulated by scatter-add over many points), f64 1e-8; K6 1e-2 relative
to the largest output, the experiment's own bound for interpret mode.
"""

import importlib.util
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from msda_tpu.ops import multiscale_deformable_attention as jax_msda  # noqa: E402
from msda_tpu.ops import native_multiscale_deformable_attention as jax_native  # noqa: E402
from msda_tpu.ops.pallas_bwd import pallas_msda_bwd  # noqa: E402
from msda_tpu.ops.pallas_fwd import pallas_multiscale_deformable_attention  # noqa: E402
from msda_tpu_torch.ops import (  # noqa: E402
    compute_level_data,
    level_shapes,
    multiscale_deformable_attention,
    native_msda_backward,
    native_multiscale_deformable_attention,
)
from msda_tpu_torch.ops import cuda_bwd, cuda_fwd, library  # noqa: E402
from oracle import torch_msda_oracle  # noqa: E402
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


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_reference_matches_grid_sample_oracle(dtype, padding_mode,
                                              align_corners):
    """The port's plain forward against the independent grid_sample
    oracle (P=3, out-of-bounds points)."""
    img, shapes, pts, wts, _ = _data(dtype)
    want = torch_msda_oracle(img, shapes, pts, wts, padding_mode,
                             align_corners)
    ti, tp, tw = _torch(img, pts, wts)
    got = native_multiscale_deformable_attention(
        ti, shapes, tp, tw, padding_mode, align_corners)
    assert got.dtype == ti.dtype
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def _load_pipeline_experiment():
    path = (Path(__file__).resolve().parents[1] / "docs" / "experiments"
            / "exp_fwd_pipeline_r4.py")
    spec = importlib.util.spec_from_file_location("exp_fwd_pipeline_r4",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_reference_matches_k6_pipeline_interpret(padding_mode,
                                                 align_corners):
    """K6 (``_pipe_kernel``) through the Pallas interpreter against the
    port's plain forward, whose kernel is K1.  ``pipe_fwd`` traces with x64
    off, as ``pallas_fwd`` does (under x64 its ``lax.rem`` mixes int32 and
    int64)."""
    pipe_fwd = _load_pipeline_experiment().pipe_fwd
    rng = np.random.default_rng(13)
    B, H, C, P, N = 1, 2, 32, 2, 100
    shapes = ((16, 16), (8, 8))
    L, I = len(shapes), sum(h * w for h, w in shapes)  # noqa: E741
    img = rng.standard_normal((B, I, H, C)).astype(np.float32)
    pts = rng.random((B, N, H, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, N, H, L * P))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    wts = (e / e.sum(-1, keepdims=True)).reshape(B, N, H, L, P).astype(
        np.float32)
    with jax.enable_x64(False):
        got = np.asarray(pipe_fwd(
            jax.numpy.asarray(img), jax.numpy.asarray(pts),
            jax.numpy.asarray(wts), shapes_tuple=shapes,
            padding_mode=padding_mode, align_corners=align_corners,
            interpret=True))
    want = native_multiscale_deformable_attention(
        *_torch(img), shapes, *_torch(pts, wts), padding_mode,
        align_corners).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-2


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


@pytest.mark.parametrize("data", [
    dict(N=130, P=3, oob=True, seed=3),    # ragged N, P=3, out of bounds
    dict(N=64, P=4, oob=False, seed=4),    # in bounds, N a power of two
], ids=["ragged_oob", "in_bounds"])
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_plain_backward_matches_pallas_interpret(padding_mode, align_corners,
                                                 data):
    """The plain version of K2 against K2 itself, run by the Pallas
    interpreter in exact f32 (precision="highest"); 1e-4 on all three
    gradients."""
    img, shapes, pts, wts, og = get_functional_data(**data)
    want = [np.asarray(g) for g in pallas_msda_bwd(
        img, shapes, pts, wts, og, padding_mode, align_corners,
        precision="highest", interpret=True)]
    got = native_msda_backward(*_torch(img), shapes, *_torch(pts, wts, og),
                               padding_mode, align_corners)
    for name, g, w in zip(("img", "points", "weights"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} gradient")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_backward_rounds_half_types_once(dtype):
    """For half-precision img, the plain backward is the f32 one rounded
    once: no gradient is accumulated in the half type."""
    img, shapes, pts, wts, og = _data(np.float32)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    half = ti.to(dtype)
    got = native_msda_backward(half, shapes, tp, tw, tog.to(dtype))
    want = native_msda_backward(half.float(), shapes, tp, tw,
                                tog.to(dtype).float())
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32]
    assert torch.equal(got[0], want[0].to(dtype))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


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
    img, shapes, pts, wts, og = _data(np.float32)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    before = cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fwd.msda_fwd(ti, shapes, tp, tw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_bwd.msda_bwd(ti, shapes, tp, tw, tog)
    assert (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES) == before


def _autograd_backward(img, shapes, pts, wts, og, padding_mode,
                       align_corners):
    """Autograd through the plain forward, every step after the geometry in
    f64: what ``native_msda_backward`` writes out."""
    from msda_tpu_torch.ops.reference import _geometry, _interpolate

    f64 = torch.float64
    leaves = [pts.detach().requires_grad_(True),
              *(t.detach().to(f64).requires_grad_(True) for t in (img, wts))]
    geometry = _geometry(shapes, leaves[0], padding_mode, align_corners,
                         img.device)
    out = _interpolate(leaves[1], geometry, leaves[2], f64)
    pg, ig, wg = torch.autograd.grad(out, leaves, og.to(f64))
    return ig.to(img.dtype), pg, wg.to(wts.dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_plain_backward_is_autograd_through_the_plain_forward(
        dtype, padding_mode, align_corners):
    """The written-out plain backward equals autograd through the plain
    forward: to f64 rounding in f64, and to one rounding of the f32 point
    gradients in f32."""
    img, shapes, pts, wts, og = _data(dtype)
    args = (*_torch(img), shapes, *_torch(pts, wts, og))
    got = native_msda_backward(*args, padding_mode, align_corners)
    want = _autograd_backward(*args, padding_mode, align_corners)
    tol = {np.float32: 1e-6, np.float64: 1e-12}[dtype]
    for name, g, w in zip(("img", "points", "weights"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=tol,
                                   err_msg=f"{name} gradient")


def _operator_args(seed=5, requires_grad=False):
    img, shapes, pts, wts, og = get_functional_data(N=17, P=3, oob=True,
                                                    seed=seed)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    if requires_grad:
        for t in (ti, tp, tw):
            t.requires_grad_(True)
    return ti, tp, tw, tog, library.flat_shapes(level_shapes(shapes))


@pytest.mark.parametrize("op", ["msda_fwd", "msda_bwd"])
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_operator_opcheck_on_cpu(op, padding_mode, align_corners):
    """``torch.library.opcheck`` (schema, fake implementation, autograd
    registration, AOT dispatch) on the operators' CPU implementations."""
    if op == "msda_fwd":
        ti, tp, tw, _, shapes = _operator_args(requires_grad=True)
        args = (ti, tp, tw, shapes, padding_mode, align_corners)
    else:
        ti, tp, tw, tog, shapes = _operator_args()
        args = (ti, tp, tw, tog, shapes, padding_mode, align_corners)
    torch.library.opcheck(getattr(library, op), args)


def test_operator_matches_the_plain_versions_on_cpu():
    ti, tp, tw, tog, shapes = _operator_args(seed=6)
    pairs = level_shapes(np.asarray(shapes).reshape(-1, 2))
    out = library.msda_fwd(ti, tp, tw, shapes, "zeros", True)
    assert torch.equal(out, native_multiscale_deformable_attention(
        ti, pairs, tp, tw, "zeros", True))
    grads = library.msda_bwd(ti, tp, tw, tog, shapes, "zeros", True)
    for g, w in zip(grads, native_msda_backward(ti, pairs, tp, tw, tog,
                                                "zeros", True)):
        assert torch.equal(g, w)


def test_operator_double_backward_raises():
    """First-order only, like impl="pallas": the autograd formula's
    backward is ``once_differentiable``."""
    ti, tp, tw, _, shapes = _operator_args(seed=7)
    tp.requires_grad_(True)
    out = library.msda_fwd(ti, tp, tw, shapes, "border", False)
    (g,) = torch.autograd.grad(out.square().sum(), tp, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_fused_alias_matches_jax_fused(padding_mode, align_corners):
    """impl="fused" is the port's alias of "reference"; it agrees with the
    JAX package's impl="fused" on the same f32 inputs (1e-5 forward, 1e-4
    gradients)."""
    img, shapes, pts, wts, og = _data(np.float32)

    def f(i, p, w):
        return jax_msda(i, shapes, p, w, padding_mode, align_corners,
                        impl="fused")

    want_out, vjp = jax.vjp(f, img, pts, wts)
    want_grads = vjp(og)
    leaves = [t.requires_grad_(True) for t in _torch(img, pts, wts)]
    out = multiscale_deformable_attention(
        leaves[0], shapes, *leaves[1:], padding_mode, align_corners,
        impl="fused")
    out.backward(_torch(og)[0])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    for name, leaf, w in zip(("img", "points", "weights"), leaves,
                             want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} gradient")


# resolved_impl: the port's against msda_tpu.ops.msda.resolved_impl on the
# CPU for the cases the two share (the JAX names mapped: "pallas" is the
# port's "cuda", "fused" its alias of "reference"), then the port's CUDA
# cases as pure logic (a CUDA device needs no card to be named)
_JAX_NAMES = {"pallas": "cuda", "fused": "reference", "reference": "reference"}
_RESOLVE_SHAPES = ((8, 8), (4, 4))


@pytest.mark.parametrize("impl,dtype", [
    ("auto", "float32"), ("auto", "float64"), ("reference", "float32"),
    ("reference", "float64"), ("fused", "float32"), ("auto", "bfloat16"),
])
def test_resolved_impl_matches_jax_on_cpu(impl, dtype):
    from msda_tpu.ops.msda import resolved_impl as jax_resolved_impl
    from msda_tpu_torch.ops import resolved_impl

    want = jax_resolved_impl(impl, np.asarray(_RESOLVE_SHAPES),
                             jax.numpy.dtype(dtype))
    got = resolved_impl(impl, _RESOLVE_SHAPES, getattr(torch, dtype), "cpu")
    assert got == _JAX_NAMES[want] == "reference"


@pytest.mark.parametrize("case", ["f64_kernel", "unknown_impl", "bad_shapes"])
def test_resolved_impl_raises_where_jax_raises(case):
    from msda_tpu.ops.msda import resolved_impl as jax_resolved_impl
    from msda_tpu_torch.ops import resolved_impl

    jax_args, args = {
        "f64_kernel": (("pallas", _RESOLVE_SHAPES, jax.numpy.float64),
                       ("cuda", _RESOLVE_SHAPES, torch.float64, "cuda")),
        "unknown_impl": (("triton", _RESOLVE_SHAPES, jax.numpy.float32),
                         ("triton", _RESOLVE_SHAPES, torch.float32, "cpu")),
        "bad_shapes": (("auto", [[8, 8, 1]], jax.numpy.float32),
                       ("auto", [[8, 8, 1]], torch.float32, "cpu")),
    }[case]
    with pytest.raises(ValueError):
        jax_resolved_impl(*jax_args)
    with pytest.raises(ValueError):
        resolved_impl(*args)


@pytest.mark.parametrize("impl,dtype,device,want", [
    ("auto", torch.float32, "cuda", "cuda"),
    ("auto", torch.bfloat16, "cuda:0", "cuda"),
    ("auto", torch.float16, torch.device("cuda"), "cuda"),
    ("auto", torch.float64, "cuda", "reference"),
    ("auto", torch.bfloat16, "cpu", "reference"),
    ("cuda", torch.float32, "cuda", "cuda"),
    ("cuda", torch.bfloat16, "cuda", "cuda"),
    ("fused", torch.float32, "cuda", "reference"),
    ("reference", torch.float32, "cuda", "reference"),
    ("cuda", torch.float32, "cpu", ValueError),
    ("cuda", torch.float64, "cuda", ValueError),
])
def test_resolved_impl_cuda_cases(impl, dtype, device, want):
    from msda_tpu_torch.ops import resolved_impl

    if want is ValueError:
        with pytest.raises(ValueError, match="impl='cuda'"):
            resolved_impl(impl, _RESOLVE_SHAPES, dtype, device)
    else:
        assert resolved_impl(impl, _RESOLVE_SHAPES, dtype, device) == want


def test_the_op_resolves_through_resolved_impl(monkeypatch):
    from msda_tpu_torch.ops import msda as op_module

    seen = []
    real = op_module.resolved_impl

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(op_module, "resolved_impl", spy)
    img, shapes, pts, wts, _ = _data(np.float32)
    ti, tp, tw = _torch(img, pts, wts)
    multiscale_deformable_attention(ti, shapes, tp, tw, impl="fused")
    assert seen == [("fused", level_shapes(shapes), torch.float32,
                     torch.device("cpu"))]
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        multiscale_deformable_attention(ti, shapes, tp, tw, impl="cuda")
