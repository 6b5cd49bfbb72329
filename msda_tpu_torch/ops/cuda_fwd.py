"""Wrapper of the CUDA forward kernel (K1) in ``csrc/msda_fwd.cu``.

The kernel replaces the TPU kernel ``msda_tpu/ops/pallas_fwd.py:_fwd_kernel``
(see the note at the top of the source for its design and what bounds it).
Its plain version is ``reference.native_multiscale_deformable_attention``.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; it never falls back to the plain
version.  Points and weights are cast to f32, as the JAX wrapper does; the
output has ``img``'s dtype.  The library is built at first use
(``_build.load_library``), and each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .reference import level_shapes

__all__ = ["LAUNCHES", "msda_fwd", "load", "check_inputs"]

KERNEL = "msda_fwd"
MAX_LEVELS = 16  # MSDA_MAX_LEVELS in the source
_INT32_MAX = 2**31 - 1
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# Number of kernel launches since import (or since a caller reset it).
LAUNCHES = 0


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; set its signature."""
    lib = _build.load_library(KERNEL)
    fn = lib.msda_fwd_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, vp,
                   ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    return lib


def check_inputs(img, img_shapes, sampling_points, attention_weights,
                 padding_mode):
    """Validate the inputs that K1 and K2 share.

    Returns ``(level_hw, pts, wts)``: the level shapes as a ctypes
    ``int[L * 2]`` array for the launch, and the points and weights cast to
    contiguous f32.  Raises ``ValueError`` on
    anything the kernels do not take.
    """
    if padding_mode not in ("border", "zeros"):
        raise ValueError(
            f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}"
        )
    if img.dtype not in DTYPE_CODES:
        raise ValueError(
            f"the CUDA kernel takes img in bf16, f16 or f32, got {img.dtype}"
        )
    tensors = (img, sampling_points, attention_weights)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            "the CUDA kernel needs CUDA tensors, got devices "
            f"{[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("img, sampling_points and attention_weights must "
                         "lie on one device")
    if img.ndim != 4 or sampling_points.ndim != 6 or (
            sampling_points.shape[-1] != 2):
        raise ValueError(
            "expected img [B, I, H, C] and sampling_points [B, N, H, L, P, 2], "
            f"got {tuple(img.shape)} and {tuple(sampling_points.shape)}"
        )
    B, I, H, C = img.shape  # noqa: E741
    Bp, N, Hp, L, P, _ = sampling_points.shape
    if (Bp, Hp) != (B, H) or (
            attention_weights.shape != sampling_points.shape[:-1]):
        raise ValueError(
            f"shape mismatch: img {tuple(img.shape)}, sampling_points "
            f"{tuple(sampling_points.shape)}, attention_weights "
            f"{tuple(attention_weights.shape)}"
        )
    shapes = level_shapes(img_shapes)
    if len(shapes) != L or not 1 <= L <= MAX_LEVELS:
        raise ValueError(
            f"img_shapes has {len(shapes)} levels; sampling_points has {L} "
            f"(the kernel takes 1 to {MAX_LEVELS})"
        )
    if sum(h * w for h, w in shapes) != I:
        raise ValueError(f"img has {I} pixels but img_shapes {shapes} "
                         f"sums to {sum(h * w for h, w in shapes)}")
    if any(h < 1 or w < 1 for h, w in shapes):
        raise ValueError(f"every level needs a positive size, got {shapes}")
    if max(img.numel(), B * N * H * L * P * 2, B * N * H * C) > _INT32_MAX:
        raise ValueError("tensors above 2**31 - 1 elements are not supported")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")

    pts = sampling_points.to(torch.float32)
    wts = attention_weights.to(torch.float32)
    if not (pts.is_contiguous() and wts.is_contiguous()):
        raise ValueError("sampling_points and attention_weights must be "
                         "contiguous")
    level_hw = (ctypes.c_int * (2 * L))(*(v for hw in shapes for v in hw))
    return level_hw, pts, wts


def msda_fwd(
    img: torch.Tensor,
    img_shapes,
    sampling_points: torch.Tensor,
    attention_weights: torch.Tensor,
    padding_mode: str = "border",
    align_corners: bool = False,
) -> torch.Tensor:
    """Launch K1 on ``torch.cuda.current_stream()``; returns ``[B, N, H, C]``.

    ``img`` is bf16, f16 or f32 and contiguous; the points and weights may
    be any float dtype (they are cast to f32).  Raises ``ValueError`` on
    inputs the kernel does not take and ``RuntimeError`` when the build or
    the launch fails.
    """
    global LAUNCHES
    level_hw, pts, wts = check_inputs(img, img_shapes, sampling_points,
                                      attention_weights, padding_mode)
    B, I, H, C = img.shape  # noqa: E741
    _, N, _, L, P, _ = pts.shape

    lib = load()
    out = torch.empty((B, N, H, C), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES += 1
        err = lib.msda_fwd_launch(
            DTYPE_CODES[img.dtype], img.data_ptr(), pts.data_ptr(),
            wts.data_ptr(), out.data_ptr(), ctypes.addressof(level_hw),
            B, I, N, H, C, L, P,
            int(padding_mode == "zeros"), int(bool(align_corners)), stream,
        )
    if err != 0:
        raise RuntimeError(f"msda_fwd_launch failed: CUDA error {err}")
    return out
