"""Public multiscale deformable attention op: validation and dispatch.

The counterpart of ``msda_tpu/ops/msda.py``.  Implementations:

    "cuda":      the hand-written CUDA kernels, the counterpart of the JAX
                 package's "pallas", through the custom operator
                 ``torch.ops.msda_tpu_torch.msda_fwd`` (``library.py``):
                 the forward K1 (``cuda_fwd.py``) and, through its autograd
                 formula, the backward K2 (``cuda_bwd.py``), which saves
                 only the inputs (the backward rematerializes the
                 sampling) and is first-order only.  It takes CUDA tensors
                 in bf16, f16 or f32 and always computes in f32.  Both
                 directions go to the streamed kernels (``cuda_stream.py``)
                 only while ``stream.FORCE`` is set (``stream.forced()``,
                 ``benchmark.py --force-stream``): K1 and K2 were the
                 faster on the model's own points at every pyramid
                 measured.
    "reference": the plain gather-based version (``reference.py``); any
                 device, f64-capable, differentiable through autograd.
    "fused":     an alias of "reference".  The JAX package's "fused" is an
                 XLA patch-gather form that exists because TPU gathers are
                 slow; it computes the same function, and is not ported.
    "auto":      "cuda" for CUDA tensors in bf16/f16/f32, "reference" for
                 CPU tensors or f64.

There is no silent fallback: with "cuda" (or "auto" on CUDA), a kernel
that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from .library import flat_shapes, msda_fwd
from .reference import level_shapes, native_multiscale_deformable_attention

__all__ = ["multiscale_deformable_attention", "resolved_impl"]

_VALID_PADDING = ("border", "zeros")
_VALID_IMPL = ("auto", "cuda", "reference", "fused")
_VALID_DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.float64)
_KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _check_inputs(img, shapes, sampling_points, attention_weights):
    for name, t in (
        ("img", img),
        ("sampling_points", sampling_points),
        ("attention_weights", attention_weights),
    ):
        if t.dtype not in _VALID_DTYPES:
            raise ValueError(
                f"Dtype of `{name}` should be one of "
                f"{[str(d).removeprefix('torch.') for d in _VALID_DTYPES]}, "
                f"got {t.dtype}."
            )
    if img.ndim != 4:
        raise ValueError(f"`img` must be [B, I, H, C], got shape "
                         f"{tuple(img.shape)}")
    if sampling_points.ndim != 6 or sampling_points.shape[-1] != 2:
        raise ValueError(
            "`sampling_points` must be [B, N, H, L, P, 2], got shape "
            f"{tuple(sampling_points.shape)}"
        )
    if attention_weights.shape != sampling_points.shape[:-1]:
        raise ValueError(
            "`attention_weights` must be [B, N, H, L, P] = "
            f"{tuple(sampling_points.shape[:-1])}, got "
            f"{tuple(attention_weights.shape)}"
        )
    B, I, H, C = img.shape  # noqa: E741
    Bp, N, Hp, L, P, _ = sampling_points.shape
    if (B, H) != (Bp, Hp):
        raise ValueError(
            f"Batch/head mismatch between img {tuple(img.shape)} and "
            f"sampling_points {tuple(sampling_points.shape)}"
        )
    if len(shapes) != L:
        raise ValueError(
            f"`img_shapes` must be [L, 2] = [{L}, 2], got [{len(shapes)}, 2]"
        )


def resolved_impl(impl: str, img_shapes, dtype,
                  device: torch.device | str = "cuda") -> str:
    """Which implementation ``multiscale_deformable_attention`` runs for
    ``img`` of ``dtype`` on ``device``: ``"cuda"`` or ``"reference"``.

    The counterpart of ``msda_tpu.ops.msda.resolved_impl``, so that a
    caller can ask before it places the op.  ``img_shapes`` is validated as
    the op validates it (``level_shapes``).  ``"auto"`` gives ``"cuda"`` for
    a CUDA device in bf16, f16 or f32 and ``"reference"`` otherwise;
    ``"fused"`` gives ``"reference"``; ``"cuda"`` in f64 or on another
    device than CUDA raises the op's ``ValueError``, as does an unknown
    ``impl``.  The JAX package's names map as: its ``"pallas"`` (the TPU
    kernels) is this package's ``"cuda"``, its ``"reference"`` is
    ``"reference"``, and its ``"fused"`` (an XLA patch-gather form, not
    ported) is here an alias of ``"reference"``.  The op resolves through
    this function.
    """
    level_shapes(img_shapes)
    if impl not in _VALID_IMPL:
        raise ValueError(f"impl must be one of {_VALID_IMPL}, got {impl!r}")
    device = torch.device(device)
    if impl == "fused":
        return "reference"
    if impl == "auto":
        if device.type == "cuda" and dtype in _KERNEL_DTYPES:
            return "cuda"
        return "reference"
    if impl == "cuda" and dtype not in _KERNEL_DTYPES:
        raise ValueError(
            "impl='cuda' supports bf16/f16/f32 only; use "
            "impl='reference' for float64."
        )
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(
            "impl='cuda' needs CUDA tensors, got img on "
            f"{device}; use impl='auto' or 'reference' on the CPU."
        )
    return impl


def multiscale_deformable_attention(
    img,
    img_shapes,
    sampling_points,
    attention_weights,
    padding_mode: str = "border",
    align_corners: bool = False,
    *,
    impl: str = "auto",
    precision=None,
):
    """Multiscale deformable attention (Deformable DETR, arXiv:2010.04159).

    Args:
        img: ``[batch, num_pixels, num_heads, head_channels]`` flattened
            feature pyramid, where ``num_pixels = sum(h_l * w_l)``.
        img_shapes: ``[num_levels, 2]`` integer (height, width) per level: a
            sequence of pairs, a numpy array or an integer tensor.  It is
            turned into a host tuple once per call; pass a tuple (see
            ``reference.level_shapes``) to skip even that.
        sampling_points: ``[batch, num_queries, num_heads, num_levels,
            num_points, 2]`` normalized (x, y) sampling locations; (0, 0) is
            the top-left corner and (1, 1) the bottom-right.
        attention_weights: ``[batch, num_queries, num_heads, num_levels,
            num_points]``.
        padding_mode: "border" clamps out-of-bounds samples to the nearest
            edge pixel, "zeros" treats outside as 0.
        align_corners: grid alignment, as in
            ``torch.nn.functional.grid_sample``.
        impl: "auto" (default), "cuda", "reference" or "fused" (an alias
            of "reference"); see the module docstring.
        precision: accepted for API parity with ``msda_tpu`` and ignored:
            the CUDA kernel always computes in f32 (and rounds once to the
            output dtype), the reference in f32 or f64.

    Returns:
        ``[batch, num_queries, num_heads, head_channels]`` in ``img.dtype``.
    """
    del precision  # both implementations compute in f32 (or f64)
    if padding_mode not in _VALID_PADDING:
        raise ValueError(
            f"padding_mode must be one of {_VALID_PADDING}, got {padding_mode!r}"
        )
    shapes = level_shapes(img_shapes)
    expected_i = sum(h * w for h, w in shapes)
    if img.ndim >= 2 and img.shape[1] != expected_i:
        raise ValueError(
            f"`img` has {img.shape[1]} pixels but `img_shapes` "
            f"{shapes} sums to {expected_i}: the flattened "
            "pyramid and the level shapes disagree."
        )
    _check_inputs(img, shapes, sampling_points, attention_weights)
    impl = resolved_impl(impl, shapes, img.dtype, img.device)
    if impl == "cuda":
        return msda_fwd(
            img.contiguous(), sampling_points.contiguous(),
            attention_weights.contiguous(), flat_shapes(shapes),
            padding_mode, bool(align_corners),
        )
    return native_multiscale_deformable_attention(
        img, shapes, sampling_points, attention_weights, padding_mode,
        bool(align_corners),
    )
