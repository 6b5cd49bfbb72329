"""The detector's residual add + LayerNorm: the operator
``torch.ops.msda_tpu_torch.add_layer_norm`` (``ops/library.py``), its
kernel (``csrc/msda_norm.cu``, wrapper ``ops/cuda_norm.py``) and the route
in ``models/detr.py``'s ``LayerNorm``.

On the CPU: the operator's CPU implementation is the chain of PyTorch
calls that ``LayerNorm`` runs (bitwise), ``torch.library.opcheck`` passes,
and the route sends a call to the operator only for CUDA half-type
activations of a supported width that autograd does not record (fake CUDA
tensors, ``FakeTensorMode``, stand in for the card's).

On the card (marked ``cuda``; skip without a GPU: the kernel has no CPU
mode): the kernel against the chain for bf16 and f16 at 1, 600, 1,003 and
44,446 rows (the decoder's and the 800x1333 encoder's rows; 1,003 is no
multiple of a block's rows) and D = 256, 392 (vectors past a warp's lanes)
and 1,024 (the largest); unsupported widths through the chain; operands
that are views off the kernel's alignment; and the route inside a
``utils.graphs.graphed`` function, captured and replayed.  The bar: at
least 99% of the outputs bitwise equal and none more than one ulp of the
output dtype apart, an ulp taken at the output's magnitude and no finer
than at 2**-10 (the two sum the statistics in different orders; ``_ulps``).
The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_norm.py
"""

from __future__ import annotations

import io
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from msda_tpu_torch.models.detr import LAYER_NORM_EPS, LayerNorm
from msda_tpu_torch.ops import cuda_norm, library
from msda_tpu_torch.utils import graphed

HALF = [torch.bfloat16, torch.float16]
ROWS = [1, 600, 1003, 44_446]
WIDTHS = [256, 392, 1024]


def _chain(a, b, weight, bias):
    """What ``LayerNorm`` computed before the kernel: the sum in the
    activations' dtype, a cast to f32, ``F.layer_norm``, a cast back."""
    y = torch.nn.functional.layer_norm(
        (a + b).to(torch.float32), (a.shape[-1],), weight.float(),
        bias.float(), LAYER_NORM_EPS)
    return y.to(a.dtype)


def _inputs(rows, D, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    a = (torch.randn(rows, D, generator=g, device=device) * 2 + 0.5).to(dtype)
    b = torch.randn(rows, D, generator=g, device=device).to(dtype)
    weight = 1 + 0.1 * torch.randn(D, generator=g, device=device)
    bias = 0.1 * torch.randn(D, generator=g, device=device)
    return a, b, weight, bias


def _norm(D, dtype, device, weight, bias):
    norm = LayerNorm(D, dtype, device=device)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    return norm


# -- the CPU --------------------------------------------------------------


@pytest.mark.parametrize("dtype", HALF + [torch.float32])
@pytest.mark.parametrize("shape", [(7, 256), (2, 5, 392), (3, 24)])
def test_cpu_implementation_is_the_chain(dtype, shape):
    """The operator's CPU implementation is ``LayerNorm``'s chain, bitwise,
    and so is ``cuda_norm.add_layer_norm_plain``."""
    a, b, weight, bias = _inputs(math.prod(shape[:-1]), shape[-1], dtype,
                                 "cpu")
    a, b = a.reshape(shape), b.reshape(shape)
    want = _chain(a, b, weight, bias)
    norm = _norm(shape[-1], dtype, "cpu", weight, bias)
    with torch.no_grad():
        assert torch.equal(norm(a + b), want)
    got = library.add_layer_norm(a, b, weight, bias, LAYER_NORM_EPS)
    assert got.dtype == dtype and got.shape == a.shape
    assert torch.equal(got, want)
    assert torch.equal(
        cuda_norm.add_layer_norm_plain(a, b, weight, bias, LAYER_NORM_EPS),
        want)


@pytest.mark.parametrize("dtype", HALF)
def test_opcheck(dtype):
    """``torch.library.opcheck``: schema, fake implementation, dispatch."""
    a, b, weight, bias = _inputs(6, 64, dtype, "cpu")
    torch.library.opcheck(library.add_layer_norm,
                          (a, b, weight, bias, LAYER_NORM_EPS))


def _no_operator(monkeypatch):
    def refuse(*args):
        raise AssertionError("the fused operator was called")
    monkeypatch.setattr(library, "add_layer_norm", refuse)


@pytest.mark.parametrize("dtype", HALF + [torch.float32])
@pytest.mark.parametrize("grad", [False, True])
def test_route_keeps_the_chain_on_the_cpu(monkeypatch, dtype, grad):
    """CPU activations, with or without autograd recording, take the chain
    (the operator is never called) and give its result bitwise."""
    _no_operator(monkeypatch)
    a, b, weight, bias = _inputs(9, 256, dtype, "cpu", seed=1)
    norm = _norm(256, dtype, "cpu", weight, bias)
    with torch.set_grad_enabled(grad):
        got = norm(a, b)
    assert got.requires_grad == grad
    assert torch.equal(got.detach(), _chain(a, b, weight, bias))


def test_route_keeps_the_chain_while_training(monkeypatch):
    """A training forward (f32 and bf16 on the CPU) reaches the chain, and
    its gradients flow through the sum to both operands."""
    _no_operator(monkeypatch)
    for dtype in (torch.float32, torch.bfloat16):
        a, b, weight, bias = _inputs(4, 64, dtype, "cpu", seed=2)
        a.requires_grad_(True)
        b.requires_grad_(True)
        norm = _norm(64, dtype, "cpu", weight, bias)
        norm(a, b).float().square().sum().backward()
        assert a.grad is not None and torch.equal(a.grad, b.grad)
        assert norm.weight.grad is not None


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("mode", ["inference", "no_grad", "no_params"])
def test_route_takes_the_operator_on_cuda_half_activations(monkeypatch,
                                                           dtype, mode):
    """Fake CUDA activations of a half type and a supported width, where
    autograd records nothing (inference mode, ``no_grad``, or parameters
    that do not require grad), go to the operator once, in one call with
    both operands; the result has the activations' dtype and shape."""
    calls = []
    fused = library.add_layer_norm

    def record(a, b, weight, bias, eps):
        calls.append((a.shape, b.shape, eps))
        return fused(a, b, weight, bias, eps)

    monkeypatch.setattr(library, "add_layer_norm", record)
    with FakeTensorMode():
        norm = LayerNorm(256, dtype, device="cuda")
        x = torch.empty(2, 5, 256, dtype=dtype, device="cuda")
        y = torch.empty(2, 5, 256, dtype=dtype, device="cuda")
        if mode == "inference":
            with torch.inference_mode():
                out = norm(x, y)
        elif mode == "no_grad":
            with torch.no_grad():
                out = norm(x, y)
        else:
            norm.requires_grad_(False)
            out = norm(x, y)
        assert (out.dtype, tuple(out.shape), out.device.type) == (
            dtype, (2, 5, 256), "cuda")
    assert calls == [((2, 5, 256), (2, 5, 256), LAYER_NORM_EPS)]


@pytest.mark.parametrize("case", [
    "f32", "mixed_operands", "f32_output", "narrow", "odd_width", "wide",
    "broadcast", "grad", "cpu"])
def test_route_refuses_what_the_kernel_does_not_serve(case):
    """Everything else keeps the chain: f32 activations, operands of two
    dtypes, an f32 output (no ``compute_dtype``), widths the kernel does not
    take, a broadcast residual, a call autograd records, CPU tensors."""
    dtype, D, residual_shape = torch.bfloat16, 256, None
    compute_dtype, device = torch.bfloat16, "cuda"
    if case == "f32":
        dtype = compute_dtype = torch.float32
    elif case == "f32_output":
        compute_dtype = None
    elif case == "narrow":
        D = 4
    elif case == "odd_width":
        D = 260
    elif case == "wide":
        D = cuda_norm.MAX_DIM + 8
    elif case == "broadcast":
        residual_shape = (1, D)
    elif case == "cpu":
        device = "cpu"
    with FakeTensorMode():
        norm = LayerNorm(D, compute_dtype, device=device)
        x = torch.empty(3, D, dtype=dtype, device=device)
        y = torch.empty(residual_shape or (3, D), device=device,
                        dtype=torch.float16 if case == "mixed_operands"
                        else dtype)
        out_dtype = compute_dtype or torch.promote_types(x.dtype,
                                                         torch.float32)
        with torch.set_grad_enabled(case == "grad"):
            assert norm._fused(x, y, out_dtype) is False
        with torch.inference_mode():
            assert norm._fused(x, y, out_dtype) is (case in ("grad",))


def test_detector_layers_pass_both_operands(monkeypatch):
    """Every LayerNorm of the detector (two an encoder layer, three a
    decoder layer) is called with the residual's two operands, and on the
    CPU each call keeps the chain."""
    from msda_tpu_torch.models import DeformableDetr

    _no_operator(monkeypatch)
    calls = []
    forward = LayerNorm.forward

    def record(self, x, residual=None):
        calls.append(residual is not None)
        return forward(self, x, residual)

    monkeypatch.setattr(LayerNorm, "forward", record)
    torch.manual_seed(0)
    model = DeformableDetr(num_classes=5, in_channels=[8, 8], emb_dim=32,
                           num_heads=4, num_points=2, num_queries=10,
                           num_encoder_layers=2, num_decoder_layers=3,
                           ffn_dim=64, with_box_refinement=True,
                           compute_dtype=torch.bfloat16)
    pyramid = [torch.randn(1, 8, 8, 8), torch.randn(1, 4, 4, 8)]
    with torch.inference_mode():
        out = model(pyramid, [[8, 8], [4, 4]])
    assert calls == [True] * (2 * 2 + 3 * 3)
    assert torch.isfinite(out["logits"]).all()


@pytest.mark.parametrize("grad", [False, True])
def test_export_traces_without_autograd(grad):
    """``export_fn`` traces under ``no_grad`` whatever the caller's grad
    mode, so that the route sees what an inference call shows it; the
    caller's mode is back after the export."""
    from msda_tpu_torch.utils import export_fn

    seen = []

    def fn(x):
        seen.append(torch.is_grad_enabled())
        return x * 2

    with torch.set_grad_enabled(grad):
        export_fn(fn, torch.ones(3))
        assert torch.is_grad_enabled() is grad
    assert seen and not any(seen)


# -- the card -------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused add + LayerNorm is a "
                    "CUDA kernel")
    return torch.device("cuda")


# mantissa bits of the output dtypes, and the magnitude below which an ulp
# is taken at this floor (see ``_ulps``)
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}
ULP_FLOOR = 2.0**-10


def _ulps(got, want):
    """``|got - want|`` in ulps of the output dtype, each taken at the
    larger of the two magnitudes and ``ULP_FLOOR``.  Below the floor the
    statistics' own f32 rounding (a few 1e-8 of the row's scale, in either
    order of summation) spans more than an ulp: an output of 1e-6 has bf16
    ulps of 8e-9.  The bitwise share counts every output."""
    g, w = got.float(), want.float()
    scale = torch.maximum(torch.maximum(g.abs(), w.abs()),
                          torch.tensor(ULP_FLOOR, device=g.device))
    _, exponent = torch.frexp(scale)  # scale = m * 2**e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(scale),
                      exponent - 1 - MANTISSA[got.dtype])
    return (g - w).abs() / ulp


def _assert_close_to_chain(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    equal = (got == want).float().mean().item()
    assert equal >= 0.99, f"only {equal:.4%} of the outputs bitwise equal"
    ulps = _ulps(got, want).max().item()
    assert ulps <= 1, f"{ulps} ulps apart"


@pytest.mark.cuda
def test_kernel_reports_its_widest_row(device):
    assert cuda_norm.load().msda_add_layer_norm_max_dim() == cuda_norm.MAX_DIM


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("D", WIDTHS)
def test_kernel_against_the_chain(device, dtype, rows, D):
    a, b, weight, bias = _inputs(rows, D, dtype, device, seed=rows + D)
    want = _chain(a, b, weight, bias)
    before = cuda_norm.LAUNCHES
    got = library.add_layer_norm(a, b, weight, bias, LAYER_NORM_EPS)
    torch.cuda.synchronize()
    assert cuda_norm.LAUNCHES == before + 1
    _assert_close_to_chain(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_kernel_on_constant_rows(device, dtype):
    """Rows whose sum is one value have no variance: both give the bias,
    bitwise."""
    _, _, weight, bias = _inputs(1, 256, dtype, device, seed=5)
    a = torch.linspace(-3, 3, 600, device=device)[:, None].expand(600, 256)
    a = a.to(dtype).contiguous()
    b = torch.zeros_like(a)
    got = library.add_layer_norm(a, b, weight, bias, LAYER_NORM_EPS)
    want = _chain(a, b, weight, bias)
    assert torch.equal(got, want)
    assert torch.equal(got, bias.to(dtype).expand(600, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_operator_copies_operands_off_the_kernels_layout(device, dtype):
    """A transposed operand and one that starts off a 16-byte boundary
    are copied by the operator's CUDA implementation; the wrapper itself
    refuses them."""
    a, b, weight, bias = _inputs(601, 256, dtype, device, seed=3)
    shifted = a.flatten()[1:1 + 600 * 256].view(600, 256)  # 2 bytes off
    crossed = b[:600].t().contiguous().t()        # not contiguous
    want = _chain(shifted, crossed, weight, bias)
    got = library.add_layer_norm(shifted, crossed, weight, bias,
                                 LAYER_NORM_EPS)
    _assert_close_to_chain(got, want)
    with pytest.raises(ValueError):
        cuda_norm.add_layer_norm(shifted, b[:600], weight, bias,
                                 LAYER_NORM_EPS)
    with pytest.raises(ValueError):
        cuda_norm.add_layer_norm(a[:600], crossed, weight, bias,
                                 LAYER_NORM_EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("D", [260, cuda_norm.MAX_DIM + 8])
def test_unsupported_width_takes_the_chain(device, dtype, D):
    """A width the kernel does not take goes through the chain: no launch,
    the chain's result bitwise; the wrapper refuses it."""
    a, b, weight, bias = _inputs(600, D, dtype, device, seed=4)
    norm = _norm(D, dtype, device, weight, bias)
    before = cuda_norm.LAUNCHES
    with torch.inference_mode():
        got = norm(a, b)
    assert cuda_norm.LAUNCHES == before
    assert torch.equal(got, _chain(a, b, weight, bias))
    with pytest.raises(ValueError):
        cuda_norm.add_layer_norm(a, b, weight, bias, LAYER_NORM_EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_route_on_the_card(device, dtype):
    """On the card the route launches the kernel without autograd and
    keeps the chain (no launch, the chain's result) while it records."""
    a, b, weight, bias = _inputs(600, 256, dtype, device, seed=6)
    norm = _norm(256, dtype, device, weight, bias)
    want = _chain(a, b, weight, bias)
    before = cuda_norm.LAUNCHES
    with torch.inference_mode():
        fused = norm(a, b)
    assert cuda_norm.LAUNCHES == before + 1
    _assert_close_to_chain(fused, want)
    recorded = norm(a, b)
    assert cuda_norm.LAUNCHES == before + 1 and recorded.requires_grad
    assert torch.equal(recorded.detach(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_graphed_route_against_the_chain(device, dtype):
    """Inside a ``graphed`` function: the warm-up, the capture and its
    replay, then replays on new operands, each against the chain; a replay
    adds the captured launch to the counter."""
    weight, bias = _inputs(1, 256, dtype, device, seed=7)[2:]
    norm = _norm(256, dtype, device, weight, bias)
    fn = graphed(lambda x, y: norm(x, y) * 2)
    with torch.inference_mode():
        for seed in range(5):
            a, b, _, _ = _inputs(44_446, 256, dtype, device, seed=10 + seed)
            before = cuda_norm.LAUNCHES
            got = fn(a, b)
            torch.cuda.synchronize()
            assert cuda_norm.LAUNCHES == before + 1
            _assert_close_to_chain(got, _chain(a, b, weight, bias) * 2)
    assert fn.stats()["replays"] >= 3


def _small_detector(device):
    from msda_tpu_torch.models import DeformableDetr, init_parameters

    model = DeformableDetr(num_classes=5, in_channels=[16, 16], emb_dim=64,
                           num_heads=4, num_points=2, num_queries=20,
                           num_encoder_layers=2, num_decoder_layers=2,
                           ffn_dim=128, with_box_refinement=True,
                           compute_dtype=torch.bfloat16, device=device)
    init_parameters(model, torch.Generator().manual_seed(0))
    g = torch.Generator(device=device).manual_seed(1)
    pyramid = [torch.randn(2, 16, 16, 16, generator=g, device=device),
               torch.randn(2, 8, 8, 16, generator=g, device=device)]
    return model.eval(), pyramid


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True])
def test_exported_detector_under_each_grad_mode(device, grad):
    """``export_fn`` of the bf16 detector traces without autograd under
    either of the caller's grad modes: the program calls ``add_layer_norm``
    (10 calls: 2 an encoder layer, 3 a decoder layer) and, loaded and
    served graphed, launches the kernel, as the live model does under
    ``inference_mode``, and serves its detections."""
    from msda_tpu_torch.utils import export_fn, load_exported

    model, pyramid = _small_detector(device)
    shapes = [(16, 16), (8, 8)]

    def serve(*pyr):
        return model(list(pyr), shapes)["logits"]

    with torch.set_grad_enabled(grad):
        blob = export_fn(serve, *pyramid)
    program = torch.export.load(io.BytesIO(blob))
    fused = [n for n in program.graph.nodes if n.op == "call_function"
             and "add_layer_norm" in str(n.target)]
    assert len(fused) == 2 * 2 + 3 * 2
    with torch.inference_mode():
        want = serve(*pyramid)
        served = load_exported(blob)
        before = cuda_norm.LAUNCHES
        for _ in range(3):  # the warm-up, the capture and its replay, a replay
            got = served(*pyramid)
        torch.cuda.synchronize()
    assert cuda_norm.LAUNCHES - before == 3 * len(fused)
    assert got.dtype == want.dtype
    assert torch.allclose(got.float(), want.float(), atol=5e-2, rtol=5e-2)
