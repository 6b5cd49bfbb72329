"""Wrappers of the streamed CUDA kernels in ``csrc/msda_stream.cu``.

The kernels replace the TPU kernels of ``msda_tpu/ops/pallas_stream.py``:
``msda_stream_fwd`` (K3', for ``_stream_fwd_kernel``) and
``msda_stream_bwd`` (K4' + K5' as one kernel, for ``_stream_bwd_pts_kernel``
and ``_stream_bwd_img_kernel``), with the binning kernels they share
(``bin_samples``).  See the note at the top of the source for their design
and what bounds them, and ``stream.py`` for the band plan, the router and
the plain versions (``stream.plain_stream_fwd`` / ``plain_stream_bwd`` /
``sample_bins``).

The wrappers check device, dtype, shape and contiguity (``cuda_fwd``'s
checks, plus the plan's) and raise on anything the kernels do not take;
they never fall back to K1/K2 or to a plain version.  Points and weights are
cast to f32.  The forward adds into a zeroed f32 buffer that is cast once to
``img``'s dtype; the backward's ``img_grad`` likewise, and its point and
weight gradients are cast to the dtypes of ``sampling_points`` and
``attention_weights``.  Every output and scratch buffer is allocated here.
The library is built at first use (``_build.load_library``).  ``LAUNCHES``
counts, per kernel, the calls that launched it: one per ``bin_samples``
(its count and scatter kernels), one per forward, one per backward.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, stream
from .cuda_fwd import DTYPE_CODES, check_inputs
from .reference import level_shapes

__all__ = ["LIBRARY", "KERNELS", "LAUNCHES", "load", "bin_samples",
           "msda_stream_fwd", "msda_stream_bwd"]

LIBRARY = "msda_stream"
KERNELS = ("msda_stream_bin", "msda_stream_fwd", "msda_stream_bwd")
#: samples of a bin that one block serves
SLICE = 4096
_INT32_MAX = 2**31 - 1

# Launches per kernel since import (or since a caller reset them).
LAUNCHES = dict.fromkeys(KERNELS, 0)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; set its signatures."""
    lib = _build.load_library(LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, ptrs in ((lib.msda_stream_count_launch, 2),
                     (lib.msda_stream_scatter_launch, 3)):
        fn.argtypes = [vp] * (ptrs + 2) + [ci] * 7 + [vp]
        fn.restype = ci
    lib.msda_stream_fwd_launch.argtypes = (
        [ci] + [vp] * 10 + [ci] * 12 + [vp])
    lib.msda_stream_fwd_launch.restype = ci
    lib.msda_stream_bwd_launch.argtypes = (
        [ci] + [vp] * 13 + [ci] * 12 + [vp])
    lib.msda_stream_bwd_launch.restype = ci
    return lib


def _raise(name, err):
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def _slices(counts):
    """The first block of each bin's slices, and an upper bound of the
    blocks: ``sum(ceil(count / SLICE)) <= ceil(total / SLICE) + bins``."""
    per_bin = torch.div(counts + (SLICE - 1), SLICE, rounding_mode="floor")
    first = torch.cumsum(per_bin, 0, dtype=torch.int32) - per_bin
    return first, counts.numel()


def bin_samples(pts: torch.Tensor, img_shapes, plan, align_corners=False):
    """Sort the samples of ``pts`` ``[B, N, H, L, P, 2]`` (contiguous f32,
    on the card) into the tiles of ``plan``.

    Returns ``(order, starts, counts)``: int32 ``order`` ``[B*N*H*L*P]``
    holds the flat sample indices bin by bin (in run-dependent order within
    a bin), and bin ``k`` is ``order[starts[k] : starts[k] + counts[k]]``;
    bins are numbered as in ``stream.sample_bins``.
    """
    shapes = level_shapes(img_shapes)
    B, N, H, L, P, _ = pts.shape
    bins = B * H * stream.num_bins(shapes, plan)
    if bins > _INT32_MAX or pts.numel() // 2 > _INT32_MAX:
        raise ValueError("more than 2**31 - 1 bins or samples")
    lib = load()
    level_hw = (ctypes.c_int * (2 * L))(*(v for hw in shapes for v in hw))
    tiles = (ctypes.c_int * (2 * L))(*(v for p in plan for v in p))
    counts = torch.zeros(bins, dtype=torch.int32, device=pts.device)
    order = torch.empty(pts.numel() // 2, dtype=torch.int32,
                        device=pts.device)
    geometry = (ctypes.addressof(level_hw), ctypes.addressof(tiles),
                B, N, H, L, P, int(bool(align_corners)), bins)
    with torch.cuda.device(pts.device):
        s = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msda_stream_bin"] += 1
        _raise("msda_stream_count_launch", lib.msda_stream_count_launch(
            pts.data_ptr(), counts.data_ptr(), *geometry, s))
        starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        cursor = starts.clone()
        _raise("msda_stream_scatter_launch", lib.msda_stream_scatter_launch(
            pts.data_ptr(), cursor.data_ptr(), order.data_ptr(), *geometry,
            s))
    return order, starts, counts


def msda_stream_fwd(
    img: torch.Tensor,
    img_shapes,
    sampling_points: torch.Tensor,
    attention_weights: torch.Tensor,
    padding_mode: str = "border",
    align_corners: bool = False,
    plan=None,
) -> torch.Tensor:
    """Launch K3' on ``torch.cuda.current_stream()``; returns ``[B, N, H, C]``
    in ``img``'s dtype.

    ``plan`` is one ``(yb, xb)`` per level (default
    ``stream.pyramid_plan``).  Raises ``ValueError`` on
    inputs or a plan the kernel does not take and ``RuntimeError`` when the
    build or a launch fails.
    """
    level_hw, pts, wts = check_inputs(img, img_shapes, sampling_points,
                                      attention_weights, padding_mode)
    shapes = level_shapes(img_shapes)
    plan = stream.check_plan(shapes, plan, img.shape[3], img.dtype)
    B, I, H, C = img.shape  # noqa: E741
    _, N, _, L, P, _ = pts.shape
    out = torch.zeros((B, N, H, C), dtype=torch.float32, device=img.device)
    if out.numel() == 0 or wts.numel() == 0:
        return out.to(img.dtype)
    order, starts, counts = bin_samples(pts, shapes, plan, align_corners)
    tiles = (ctypes.c_int * (2 * L))(*(v for p in plan for v in p))
    lib = load()
    with torch.cuda.device(img.device):
        slices, bins = _slices(counts)
        blocks = -(-order.numel() // SLICE) + bins
        s = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msda_stream_fwd"] += 1
        _raise("msda_stream_fwd_launch", lib.msda_stream_fwd_launch(
            DTYPE_CODES[img.dtype], img.data_ptr(), pts.data_ptr(),
            wts.data_ptr(), order.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), slices.data_ptr(), out.data_ptr(),
            ctypes.addressof(level_hw), ctypes.addressof(tiles), B, I, N, H,
            C, L, P, int(padding_mode == "zeros"), int(bool(align_corners)),
            bins, blocks, SLICE, s))
    return out.to(img.dtype)


def msda_stream_bwd(
    img: torch.Tensor,
    img_shapes,
    sampling_points: torch.Tensor,
    attention_weights: torch.Tensor,
    out_grad: torch.Tensor,
    padding_mode: str = "border",
    align_corners: bool = False,
    plan=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K4' + K5' on ``torch.cuda.current_stream()``.

    ``out_grad`` is ``[B, N, H, C]`` in ``img``'s dtype, contiguous, on
    ``img``'s device; ``plan`` as for :func:`msda_stream_fwd`.  Returns ``(img_grad,
    sampling_points_grad, attention_weights_grad)`` in the dtypes of the
    three inputs.  Raises as :func:`msda_stream_fwd` does.
    """
    level_hw, pts, wts = check_inputs(img, img_shapes, sampling_points,
                                      attention_weights, padding_mode)
    shapes = level_shapes(img_shapes)
    plan = stream.check_plan(shapes, plan, img.shape[3], img.dtype)
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
    order, starts, counts = bin_samples(pts, shapes, plan, align_corners)
    tiles = (ctypes.c_int * (2 * L))(*(v for p in plan for v in p))
    lib = load()
    img_grad = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    pts_grad = torch.empty(pts.shape, dtype=torch.float32, device=img.device)
    wts_grad = torch.empty(wts.shape, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        slices, bins = _slices(counts)
        blocks = -(-order.numel() // SLICE) + bins
        s = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msda_stream_bwd"] += 1
        _raise("msda_stream_bwd_launch", lib.msda_stream_bwd_launch(
            DTYPE_CODES[img.dtype], img.data_ptr(), pts.data_ptr(),
            wts.data_ptr(), out_grad.data_ptr(), order.data_ptr(),
            starts.data_ptr(), counts.data_ptr(), slices.data_ptr(),
            img_grad.data_ptr(), pts_grad.data_ptr(), wts_grad.data_ptr(),
            ctypes.addressof(level_hw), ctypes.addressof(tiles), B, I, N, H,
            C, L, P, int(padding_mode == "zeros"), int(bool(align_corners)),
            bins, blocks, SLICE, s))
    return (img_grad.to(img.dtype),
            pts_grad.to(sampling_points.dtype),
            wts_grad.to(attention_weights.dtype))
