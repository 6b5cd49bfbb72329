"""The MSDA op as two ``torch.library`` custom operators.

``torch.ops.msda_tpu_torch.msda_fwd`` and ``msda_bwd`` are the op's
forward and backward as the dispatcher sees them: functional operators
with a schema, a fake (meta) implementation, an autograd formula and one
implementation per device.  So ``torch.export`` and ``torch.compile``
can trace a model whose op runs the CUDA kernels (their fake tensors have
no storage, and the kernels' wrappers launch on ``data_ptr()``), and an
exported program calls the kernels when it is loaded in a process that
imported this package.

    msda_fwd(img, sampling_points, attention_weights, level_shapes,
             padding_mode, align_corners) -> out
    msda_bwd(img, sampling_points, attention_weights, out_grad,
             level_shapes, padding_mode, align_corners)
        -> (img_grad, sampling_points_grad, attention_weights_grad)

``level_shapes`` is the flat ``[h_0, w_0, h_1, w_1, ...]``.  The
implementations, by the device of the tensors:

    CUDA: the hand-written kernels: K1 forward and K2 backward, or K3'
          and K4' + K5' when ``stream.FORCE`` is set (``stream.forced()``,
          ``benchmark.py --force-stream``), through the wrappers of
          ``cuda_fwd``, ``cuda_bwd`` and ``cuda_stream``, which check the
          inputs, count their launches and raise on a failed build or
          launch.  No fallback.
    CPU:  the plain versions, ``reference.native_multiscale_deformable_attention``
          and ``reference.native_msda_backward``: what the kernels compute,
          so that ``torch.library.opcheck``, export and the tests run
          without a card.  ``multiscale_deformable_attention`` never sends
          a CPU tensor here (``impl="cuda"`` on the CPU raises); callers
          reach it through ``torch.ops`` only.

The fake implementations compute shapes and dtypes only: the forward
``[B, N, H, C]`` in ``img``'s dtype, the backward the three inputs'
shapes and dtypes, as both the kernels' wrappers and the plain version
return them.  ``msda_fwd``'s autograd formula (its implementation for the
Autograd key, a ``torch.autograd.Function``) saves only the three inputs
(the backward rematerializes the sampling) and calls ``msda_bwd`` on a
contiguous ``out_grad``.  It is first-order only, like the JAX package's
``impl="pallas"``: a double backward raises (``once_differentiable``).

The operators are registered through ``torch.library.Library`` (schema
strings, per-device ``impl``), not ``torch.library.custom_op`` or
``register_autograd``, whose Python layers add host time to each of the
model's 12 calls a forward and 12 a backward: on an H100's host, a
forward + backward call at the decoder's shape took 0.3 ms more with
``register_autograd`` than with the ``autograd.Function`` before it
(``docs/experiments/torch_dispatch_ab.py``, ``PERF.md``).

``add_layer_norm`` is the detector's residual add + LayerNorm for
half-type activations (``models/detr.py``'s ``LayerNorm``), one operator so
that an exported or captured model keeps it:

    add_layer_norm(a, b, weight, bias, eps) -> out

``out`` is the LayerNorm of ``a + b`` over the last dimension, in ``a``'s
dtype.  CUDA: ``cuda_norm.add_layer_norm``, the hand-written kernel (bf16
and f16, D a multiple of 8 up to 1024; operands that are not contiguous or
16-byte aligned are copied first).  CPU: ``cuda_norm.add_layer_norm_plain``,
the chain of PyTorch calls that the kernel replaces: the sum in ``a``'s
dtype, ``F.layer_norm`` in f32, a cast back.  It has no autograd formula:
``LayerNorm`` calls it only where autograd records nothing.

The CUDA implementations run in the host spans ``msda.fwd`` and
``msda.bwd`` (``utils.profile.annotate``; recorded only while a profiler
runs, and never a device span): the op's own host work, its input checks
and the launch, apart from the dispatcher and autograd around it.  The
backward's span is on autograd's thread.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.profile import annotate
from . import cuda_norm, stream
from .reference import native_msda_backward, native_multiscale_deformable_attention

__all__ = ["msda_fwd", "msda_bwd", "add_layer_norm", "flat_shapes"]

NAMESPACE = "msda_tpu_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define(
    "msda_fwd(Tensor img, Tensor sampling_points, Tensor attention_weights, "
    "int[] level_shapes, str padding_mode, bool align_corners) -> Tensor")
_LIB.define(
    "msda_bwd(Tensor img, Tensor sampling_points, Tensor attention_weights, "
    "Tensor out_grad, int[] level_shapes, str padding_mode, "
    "bool align_corners) -> (Tensor, Tensor, Tensor)")
_LIB.define(
    "add_layer_norm(Tensor a, Tensor b, Tensor weight, Tensor bias, "
    "float eps) -> Tensor")


def flat_shapes(shapes) -> list[int]:
    """``((h, w), ...)`` -> the schema's flat ``[h_0, w_0, h_1, w_1, ...]``."""
    return [int(v) for hw in shapes for v in hw]


def _pairs(level_shapes) -> tuple[tuple[int, int], ...]:
    flat = [int(v) for v in level_shapes]
    return tuple(zip(flat[0::2], flat[1::2]))


def _fwd_cuda(img, sampling_points, attention_weights, level_shapes,
              padding_mode, align_corners):
    from . import cuda_fwd, cuda_stream

    with annotate("msda.fwd"):
        fwd = (cuda_stream.msda_stream_fwd if stream.FORCE
               else cuda_fwd.msda_fwd)
        return fwd(img, _pairs(level_shapes), sampling_points,
                   attention_weights, padding_mode, align_corners)


def _bwd_cuda(img, sampling_points, attention_weights, out_grad,
              level_shapes, padding_mode, align_corners):
    from . import cuda_bwd, cuda_stream

    with annotate("msda.bwd"):
        bwd = (cuda_stream.msda_stream_bwd if stream.FORCE
               else cuda_bwd.msda_bwd)
        return bwd(img, _pairs(level_shapes), sampling_points,
                   attention_weights, out_grad, padding_mode, align_corners)


def _fwd_cpu(img, sampling_points, attention_weights, level_shapes,
             padding_mode, align_corners):
    return native_multiscale_deformable_attention(
        img, _pairs(level_shapes), sampling_points, attention_weights,
        padding_mode, align_corners).contiguous()


def _bwd_cpu(img, sampling_points, attention_weights, out_grad,
             level_shapes, padding_mode, align_corners):
    grads = native_msda_backward(
        img, _pairs(level_shapes), sampling_points, attention_weights,
        out_grad, padding_mode, align_corners)
    return tuple(g.contiguous() for g in grads)


def _dense(t):
    """``t`` as the kernel takes it: contiguous and 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _add_norm_cuda(a, b, weight, bias, eps):
    return cuda_norm.add_layer_norm(_dense(a), _dense(b), _dense(weight),
                                    _dense(bias), eps)


_LIB.impl("msda_fwd", _fwd_cuda, "CUDA")
_LIB.impl("msda_bwd", _bwd_cuda, "CUDA")
_LIB.impl("msda_fwd", _fwd_cpu, "CPU")
_LIB.impl("msda_bwd", _bwd_cpu, "CPU")
_LIB.impl("add_layer_norm", _add_norm_cuda, "CUDA")
_LIB.impl("add_layer_norm", cuda_norm.add_layer_norm_plain, "CPU")


@torch.library.register_fake(f"{NAMESPACE}::msda_fwd", lib=_LIB)
def _fwd_fake(img, sampling_points, attention_weights, level_shapes,
              padding_mode, align_corners):
    B, _, H, C = img.shape
    return img.new_empty((B, sampling_points.shape[1], H, C))


@torch.library.register_fake(f"{NAMESPACE}::msda_bwd", lib=_LIB)
def _bwd_fake(img, sampling_points, attention_weights, out_grad,
              level_shapes, padding_mode, align_corners):
    return (img.new_empty(img.shape),
            sampling_points.new_empty(sampling_points.shape),
            attention_weights.new_empty(attention_weights.shape))


@torch.library.register_fake(f"{NAMESPACE}::add_layer_norm", lib=_LIB)
def _add_norm_fake(a, b, weight, bias, eps):
    return a.new_empty(a.shape)


class _MSDA(torch.autograd.Function):
    """``msda_fwd``'s autograd formula, its implementation for the
    dispatcher's Autograd key: the forward saves only the three inputs and
    runs the operator below autograd; the backward calls ``msda_bwd``.
    First-order only (``once_differentiable``)."""

    @staticmethod
    def forward(ctx, img, sampling_points, attention_weights, level_shapes,
                padding_mode, align_corners):
        ctx.save_for_backward(img, sampling_points, attention_weights)
        ctx.geometry = (level_shapes, padding_mode, align_corners)
        with torch._C._AutoDispatchBelowAutograd():
            return msda_fwd(img, sampling_points, attention_weights,
                            level_shapes, padding_mode, align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, out_grad):
        img, sampling_points, attention_weights = ctx.saved_tensors
        grads = msda_bwd(img, sampling_points, attention_weights,
                         out_grad.contiguous(), *ctx.geometry)
        return (*grads, None, None, None)


_LIB.impl("msda_fwd", _MSDA.apply, "Autograd")

msda_fwd = torch.ops.msda_tpu_torch.msda_fwd
msda_bwd = torch.ops.msda_tpu_torch.msda_bwd
add_layer_norm = torch.ops.msda_tpu_torch.add_layer_norm
