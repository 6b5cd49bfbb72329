"""The attention module's sampling-point and softmax prologue: the chain of
PyTorch calls that turns the query projection's output into the op's
points and weights (``ops.cuda_fwd_queries.sampling_plain``), the operator
``torch.ops.msda_tpu_torch.msda_fwd_queries`` (``ops/library.py``) and the
route in ``models/attention.py``'s ``MultiscaleDeformableAttention``.

On the CPU: the factored chain is bitwise what the module's forward
computed before it was factored out (2- and 4-coordinate reference points,
both offset normalizers, f32 and bf16 projections), and so are the module
and the operator's CPU implementation; the route sends a call to the
operator only for CUDA tensors where autograd records nothing, there is no
mesh, the op resolves to "cuda" and streaming is not forced (fake CUDA
tensors, ``FakeTensorMode``, stand in for the card's); the fake
implementation gives the kernel's shape and dtype.  The kernel itself is
held to the chain and K1 on the card in ``tests/test_torch_kernels.py``.
The file imports no JAX.
"""

from __future__ import annotations

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from msda_tpu_torch.models.attention import MultiscaleDeformableAttention
from msda_tpu_torch.ops import (cuda_fwd_queries, launches, level_shapes,
                                library, multiscale_deformable_attention,
                                native_multiscale_deformable_attention,
                                stream)

SHAPES = ((6, 5), (3, 3), (2, 1))
I = sum(h * w for h, w in SHAPES)  # noqa: E741
EMB, HEADS, POINTS = 32, 4, 4


def _module(dtype=None, normalizer="reference", seed=0):
    torch.manual_seed(seed)
    module = MultiscaleDeformableAttention(
        EMB, EMB, len(SHAPES), HEADS, POINTS, offset_normalizer=normalizer,
        compute_dtype=dtype)
    with torch.no_grad():  # offsets of a few pixels, logits of a few units
        module.query_input_proj.weight.mul_(8.0)
    return module


def _fake_module(monkeypatch, dtype=None, device="cuda",
                 normalizer="reference", impl="auto"):
    """The module with uninitialised parameters on ``device``, made inside
    a ``FakeTensorMode`` (a CPU build cannot draw random numbers on a fake
    CUDA device, and the values do not matter there)."""
    monkeypatch.setattr(torch.nn.Linear, "reset_parameters", lambda self: None)
    return MultiscaleDeformableAttention(
        EMB, EMB, len(SHAPES), HEADS, POINTS, offset_normalizer=normalizer,
        impl=impl, compute_dtype=dtype, device=device)


def _inputs(R, N=7, B=2, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(B, I, EMB, generator=g).to(device)
    queries = torch.randn(B, N, EMB, generator=g).to(device)
    if R == 2:
        refs = torch.rand(N, 2, generator=g)[None].expand(B, N, 2)
    else:
        refs = torch.cat([torch.rand(B, N, 2, generator=g),
                          0.05 + 0.5 * torch.rand(B, N, 2, generator=g)], -1)
    return img, queries, refs.to(device)


def _old_forward(module, img, img_shapes, queries, reference_points):
    """The module's forward before the chain was factored out (no mesh),
    as it was written."""
    B, I, _ = img.shape  # noqa: E741
    H, L, P = module.num_heads, module.num_levels, module.num_points
    Dh = module.hidden_dim // H
    N = queries.shape[1]
    q = module.query_input_proj(queries)
    q = q.to(torch.promote_types(q.dtype, torch.float32))
    q = q.reshape(B, N, H, L, P, 3)
    offsets, logits = q[..., :2], q[..., 2]
    attention_weights = torch.softmax(
        logits.reshape(B, N, H, L * P), dim=-1
    ).reshape(B, N, H, L, P)
    img_p = module.img_input_proj(img).reshape(B, I, H, Dh)
    shapes = level_shapes(img_shapes)
    if reference_points.shape[-1] == 2:
        hw = torch.tensor(shapes, dtype=offsets.dtype, device=offsets.device)
        normalizer = hw if module.offset_normalizer == "reference" else (
            hw.flip(-1))
        sampling_points = (
            reference_points[:, :, None, None, None, :]
            + offsets / normalizer[:, None, :]
        )
    else:
        sampling_points = (
            reference_points[:, :, None, None, None, :2]
            + offsets
            * reference_points[:, :, None, None, None, 2:]
            / (2 * P)
        )
    out = multiscale_deformable_attention(
        img_p, shapes, sampling_points, attention_weights,
        module.padding_mode, module.align_corners, impl=module.impl)
    return (module.query_output_proj(out.reshape(B, N, H * Dh)),
            (img_p, q, sampling_points, attention_weights))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("normalizer", ["reference", "detr"])
@pytest.mark.parametrize("R", [2, 4])
def test_factored_chain_is_what_forward_computed(dtype, normalizer, R):
    """``sampling_plain``'s points and weights, the module's output and the
    operator's CPU implementation, each bitwise what the forward computed
    before the chain was factored out."""
    module = _module(dtype, normalizer=normalizer)
    img, queries, refs = _inputs(R)
    with torch.no_grad():
        want, (img_p, q, pts, wts) = _old_forward(module, img, SHAPES,
                                                  queries, refs)
        got_pts, got_wts = cuda_fwd_queries.sampling_plain(
            module.query_input_proj(queries).reshape(q.shape), refs, SHAPES,
            normalizer)
        assert got_pts.dtype == got_wts.dtype == torch.float32
        assert torch.equal(got_pts, pts) and torch.equal(got_wts, wts)
        assert torch.equal(module(img, SHAPES, queries, refs), want)
        q_raw = module.query_input_proj(queries).reshape(q.shape)
        out = library.msda_fwd_queries(
            img_p, q_raw, refs, library.flat_shapes(SHAPES), normalizer,
            "border", False)
    assert out.dtype == img_p.dtype and out.shape == (*q.shape[:3], 8)
    assert torch.equal(out, native_multiscale_deformable_attention(
        img_p, SHAPES, pts, wts, "border", False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("R", [2, 4])
def test_operator_passes_opcheck(dtype, R):
    """``torch.library.opcheck`` of the operator's CPU implementation:
    schema, fake implementation, dispatch."""
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, I, HEADS, 8, generator=g).to(dtype)
    q = (4 * torch.randn(2, 5, HEADS, len(SHAPES), POINTS, 3,
                         generator=g)).to(dtype)
    refs = torch.rand(2, 5, R, generator=g)
    torch.library.opcheck(library.msda_fwd_queries,
                          (img, q, refs, library.flat_shapes(SHAPES),
                           "detr", "zeros", True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_fake_implementation_gives_the_kernels_shape_and_dtype(dtype):
    with FakeTensorMode():
        img = torch.empty(2, I, HEADS, 8, dtype=dtype, device="cuda")
        q = torch.empty(2, 300, HEADS, len(SHAPES), POINTS, 3, dtype=dtype,
                        device="cuda")
        refs = torch.empty(2, 300, 4, device="cuda")
        out = library.msda_fwd_queries(img, q, refs,
                                       library.flat_shapes(SHAPES),
                                       "reference", "border", False)
        assert (out.dtype, tuple(out.shape), out.device.type) == (
            dtype, (2, 300, HEADS, 8), "cuda")


def test_the_route_has_a_launch_counter():
    """The variant's counter is in the registry under its kernel's name."""
    assert cuda_fwd_queries.KERNEL == "msda_fwd_queries"
    assert "msda_fwd_queries" in launches.counts()


def _recorder(monkeypatch):
    calls = []
    fused = library.msda_fwd_queries

    def record(img, q, refs, flat, *args):
        calls.append((tuple(img.shape), tuple(q.shape), tuple(refs.shape),
                      *args))
        return fused(img, q, refs, flat, *args)

    monkeypatch.setattr(library, "msda_fwd_queries", record)
    return calls


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("mode", ["inference", "no_grad", "no_params"])
def test_route_takes_the_operator_on_cuda_without_autograd(monkeypatch,
                                                           dtype, R, mode):
    """Fake CUDA tensors, where autograd records nothing (inference mode,
    ``no_grad``, or parameters that do not require grad), no mesh, the op
    resolving to "cuda": one call of the operator with the projection's
    output ``[B, N, H, L, P, 3]`` and the reference points; the module's
    output keeps its shape and dtype."""
    calls = _recorder(monkeypatch)
    with FakeTensorMode():
        module = _fake_module(monkeypatch, dtype, normalizer="detr")
        img = torch.empty(2, I, EMB, device="cuda")
        queries = torch.empty(2, 7, EMB, device="cuda")
        refs = torch.empty(2, 7, R, device="cuda")
        if mode == "inference":
            with torch.inference_mode():
                out = module(img, SHAPES, queries, refs)
        elif mode == "no_grad":
            with torch.no_grad():
                out = module(img, SHAPES, queries, refs)
        else:
            module.requires_grad_(False)
            out = module(img, SHAPES, queries, refs)
        assert (out.dtype, tuple(out.shape), out.device.type) == (
            dtype or torch.float32, (2, 7, EMB), "cuda")
    assert calls == [((2, I, HEADS, EMB // HEADS),
                      (2, 7, HEADS, len(SHAPES), POINTS, 3), (2, 7, R),
                      "detr", "border", False)]


# (levels, points a level) of each case's q that is not the module's: rows
# of q that no 4-byte copy divides (bf16, 9 points a head), more than a
# warp of points a head (33), fewer than 3 (2)
CASE_POINTS = {"odd_rows": (3, 3), "many_points": (3, 11),
               "two_points": (1, 2)}


@pytest.mark.parametrize("case", ["cpu", "grad", "mesh", "reference",
                                  "fused_alias", "forced", "f64",
                                  "mixed_dtypes", "f64_points", "three_coords",
                                  "odd_rows", "many_points", "two_points",
                                  "misaligned_q"])
def test_route_keeps_the_chain(monkeypatch, case):
    """Everything else keeps the chain and the op: CPU tensors, a call that
    autograd records, a mesh, ``impl="reference"`` (and its alias
    ``"fused"``), ``stream.forced()``, f64, a projection and a pyramid of two
    dtypes, f64 reference points, points of neither 2 nor 4 coordinates,
    and shapes the variant does not take (``cuda_fwd_queries.takes``): a
    bf16 row of 9 points, 33 or 2 points a head, and bf16 q starting off a
    4-byte boundary."""
    def refuse(*args):
        raise AssertionError("the prologue operator was called")

    monkeypatch.setattr(library, "msda_fwd_queries", refuse)
    device = "cpu" if case == "cpu" else "cuda"
    impl = {"reference": "reference", "fused_alias": "fused"}.get(case,
                                                                 "auto")
    dtype = {"f64": torch.float64, "mixed_dtypes": torch.bfloat16,
             "odd_rows": torch.bfloat16, "misaligned_q": torch.bfloat16}.get(
        case, torch.float32)
    with FakeTensorMode():
        module = _fake_module(monkeypatch, device=device, impl=impl)
        B, N = 2, 7
        img = torch.empty(B, I, HEADS, 8, dtype=dtype, device=device)
        shape = (B, N, HEADS,
                 *CASE_POINTS.get(case, (len(SHAPES), POINTS)), 3)
        offset = int(case == "misaligned_q")
        numel = B * N * HEADS * shape[3] * shape[4] * 3
        q = torch.empty(numel + offset, device=device, dtype=torch.float32
                        if case == "mixed_dtypes" else dtype).narrow(
                            0, offset, numel).view(shape)
        refs = torch.empty(B, N, 3 if case == "three_coords" else 2,
                           device=device, dtype=torch.float64
                           if case == "f64_points" else torch.float32)
        if case == "mesh":
            module.mesh = object()
        if case == "grad":
            q.requires_grad_(True)
        with torch.set_grad_enabled(case == "grad"), (
                stream.forced() if case == "forced"
                else torch.inference_mode(case != "grad")):
            assert module._fused(img, q, refs, SHAPES) is False
        if case == "cpu":  # the whole forward runs the chain and the op
            img, queries = (torch.empty(B, I, EMB), torch.empty(B, N, EMB))
            with torch.inference_mode():
                out = module(img, SHAPES, queries, torch.empty(B, N, 4))
            assert tuple(out.shape) == (B, N, EMB)


def test_training_forward_keeps_the_chain(monkeypatch):
    """A forward that autograd records (the CPU, as a train step runs
    it) reaches the chain, and its gradients reach the query projection
    through the points and the weights."""
    def refuse(*args):
        raise AssertionError("the prologue operator was called")

    monkeypatch.setattr(library, "msda_fwd_queries", refuse)
    module = _module()
    img, queries, refs = _inputs(4)
    module(img, SHAPES, queries, refs).square().sum().backward()
    grad = module.query_input_proj.weight.grad
    assert grad is not None and grad.abs().sum() > 0
