"""Wrapper of the CUDA backward kernel (K2) in ``csrc/msda_bwd.cu``.

The kernel replaces the TPU kernel ``msda_tpu/ops/pallas_bwd.py:_bwd_kernel``
(see the note at the top of the source for its design and what bounds it).
Its plain version is ``reference.native_msda_backward``.

The wrapper checks device, dtype, shape and contiguity (the checks it shares
with K1, ``cuda_fwd.check_inputs``, plus ``out_grad``'s) and raises on
anything the kernel does not take; it never falls back to the plain version.
The kernel adds ``img_grad`` with f32 atomics into a zeroed f32 buffer, which
is cast once to ``img``'s dtype; the point and weight gradients are computed
in f32 and cast to the dtypes of ``sampling_points`` and
``attention_weights``, as the JAX wrapper casts them.  The library is built
at first use (``_build.load_library``), and each launch adds one to
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, launches
from .cuda_fwd import DTYPE_CODES, check_inputs

__all__ = ["LAUNCHES", "msda_bwd", "load"]

KERNEL = "msda_bwd"

# Number of kernel launches since import (or since a caller reset it).
LAUNCHES = 0
launches.register(__name__)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; set its signature."""
    lib = _build.load_library(KERNEL)
    fn = lib.msda_bwd_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp,
                   ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    return lib


def msda_bwd(
    img: torch.Tensor,
    img_shapes,
    sampling_points: torch.Tensor,
    attention_weights: torch.Tensor,
    out_grad: torch.Tensor,
    padding_mode: str = "border",
    align_corners: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on ``torch.cuda.current_stream()``.

    ``out_grad`` is ``[B, N, H, C]`` in ``img``'s dtype, contiguous, on
    ``img``'s device.  Returns ``(img_grad, sampling_points_grad,
    attention_weights_grad)`` in the dtypes of the three inputs.  Raises
    ``ValueError`` on inputs the kernel does not take and ``RuntimeError``
    when the build or the launch fails.
    """
    global LAUNCHES
    level_hw, pts, wts = check_inputs(img, img_shapes, sampling_points,
                                      attention_weights, padding_mode)
    B, I, H, C = img.shape  # noqa: E741
    _, N, _, L, P, _ = pts.shape
    if out_grad.shape != (B, N, H, C):
        raise ValueError(f"out_grad must be [B, N, H, C] = {(B, N, H, C)}, "
                         f"got {tuple(out_grad.shape)}")
    if out_grad.dtype != img.dtype or out_grad.device != img.device:
        raise ValueError(
            f"out_grad must match img's dtype and device ({img.dtype} on "
            f"{img.device}), got {out_grad.dtype} on {out_grad.device}")
    if not out_grad.is_contiguous():
        raise ValueError("out_grad must be contiguous")

    if img.numel() == 0 or wts.numel() == 0:
        return (torch.zeros_like(img), torch.zeros_like(sampling_points),
                torch.zeros_like(attention_weights))
    lib = load()
    img_grad = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    pts_grad = torch.empty(pts.shape, dtype=torch.float32, device=img.device)
    wts_grad = torch.empty(wts.shape, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES += 1
        err = lib.msda_bwd_launch(
            DTYPE_CODES[img.dtype], img.data_ptr(), pts.data_ptr(),
            wts.data_ptr(), out_grad.data_ptr(), img_grad.data_ptr(),
            pts_grad.data_ptr(), wts_grad.data_ptr(),
            ctypes.addressof(level_hw), B, I, N, H, C, L, P,
            int(padding_mode == "zeros"), int(bool(align_corners)), stream,
        )
    if err != 0:
        raise RuntimeError(f"msda_bwd_launch failed: CUDA error {err}")
    return (img_grad.to(img.dtype),
            pts_grad.to(sampling_points.dtype),
            wts_grad.to(attention_weights.dtype))
