"""Wrappers of the streamed CUDA kernels in ``csrc/msda_stream.cu``.

The kernels replace the TPU kernels of ``msda_tpu/ops/pallas_stream.py``:
``msda_stream_fwd`` (K3', for ``_stream_fwd_kernel`` :206) and
``msda_stream_bwd`` (K4' + K5' as one kernel, for ``_stream_bwd_pts_kernel``
:330 and ``_stream_bwd_img_kernel`` :411), with the binning kernels they
share (``bin_samples``, for the band selection of ``_band_factors`` :187).
``stream.py`` holds the band plan, ``FORCE`` and the plain versions
(``stream.plain_stream_fwd`` / ``plain_stream_bwd`` / ``sample_bins``).

What the source's note sets out, measured on an H100 (``PERF.md``): the
first kernels had no single bound (staging, atomics and geometry
broadcasts each cost 10-25%).  The redesign bins each sample's record
(point, weight, index) so that the kernels read 16 contiguous bytes a
sample; persistent blocks take chunks of a cost line from a counter; a
ring of two tiles and two record buffers keeps the next slice's copies in
flight (cp.async, L2 evict-first) while one is served; one thread a
sample computes its geometry into shared memory for its group of lanes;
the forward sums a query's points on a tile in registers; the backward
counting-sorts each slice by pixel so that runs on the same four pixels
add their ``img_grad`` terms once, and stores each sample's point and
weight gradients at its index.  As whole calls (binning, buffers and
casts included) both are faster than the first kernels at every size
measured, but K1 and K2 stay faster on the model's own points, so the
operators send a call here only while ``stream.FORCE`` is set
(``stream.forced()``, ``benchmark.py --force-stream``).

The wrappers check device, dtype, shape and contiguity (``cuda_fwd``'s
checks, plus the plan's) and raise on anything the kernels do not take;
they never fall back to K1/K2 or to a plain version.  Points and weights are
cast to f32.  The forward adds into a zeroed f32 buffer that is cast once to
``img``'s dtype; the backward's ``img_grad`` likewise, and its point and
weight gradients are cast to the dtypes of ``sampling_points`` and
``attention_weights``.  Every output and scratch buffer is allocated here.
The library is built at first use (``_build.load_library``).  ``LAUNCHES``
counts, per kernel, the calls that launched it: one per ``bin_samples``
(its count, scan and scatter kernels), one per forward, one per backward.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, launches, stream
from .cuda_fwd import DTYPE_CODES, check_inputs
from .reference import level_shapes

__all__ = ["LIBRARY", "KERNELS", "LAUNCHES", "load", "bin_samples",
           "msda_stream_fwd", "msda_stream_bwd"]

LIBRARY = "msda_stream"
KERNELS = ("msda_stream_bin", "msda_stream_fwd", "msda_stream_bwd")
_INT32_MAX = 2**31 - 1

# Launches per kernel since import (or since a caller reset them).
LAUNCHES = dict.fromkeys(KERNELS, 0)
launches.register(__name__)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; set its signatures."""
    lib = _build.load_library(LIBRARY)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, ptrs in ((lib.msda_stream_count_launch, 2),
                     (lib.msda_stream_scatter_launch, 4)):
        fn.argtypes = [vp] * (ptrs + 2) + [ci] * 7 + [vp]
        fn.restype = ci
    lib.msda_stream_scan_launch.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.msda_stream_scan_launch.restype = ci
    lib.msda_stream_fwd_launch.argtypes = [ci] + [vp] * 8 + [ci] * 10 + [vp]
    lib.msda_stream_fwd_launch.restype = ci
    lib.msda_stream_bwd_launch.argtypes = [ci] + [vp] * 11 + [ci] * 10 + [vp]
    lib.msda_stream_bwd_launch.restype = ci
    return lib


def _raise(name, err):
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def bin_samples(pts: torch.Tensor, wts: torch.Tensor, img_shapes, plan,
                align_corners=False):
    """Sort the samples of ``pts`` ``[B, N, H, L, P, 2]`` and ``wts``
    ``[B, N, H, L, P]`` (contiguous f32, on the card) into the tiles of
    ``plan``.

    Returns ``(records, starts, counts, staged)``: f32 ``records``
    ``[B*N*H*L*P, 4]`` holds each sample's (x, y, weight, flat index as
    int32 bits) bin by bin (in run-dependent order within a bin), and bin
    ``k`` is ``records[starts[k] : starts[k] + counts[k]]``; bins are
    numbered as in ``stream.sample_bins``.  int64 ``staged`` ``[bins + 2]``
    holds a zero last (the counter from which the kernels' blocks take
    chunks of their work), and before it the exclusive sum of the staged
    pixels of the non-empty bins' tiles:
    with ``starts``, the cost line on which the kernels split their work.
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
    starts, cursor = torch.empty((2, bins), dtype=torch.int32,
                                 device=pts.device)
    staged = torch.empty(bins + 2, dtype=torch.int64, device=pts.device)
    records = torch.empty((pts.numel() // 2, 4), dtype=torch.float32,
                          device=pts.device)
    tables = (ctypes.addressof(level_hw), ctypes.addressof(tiles))
    geometry = (*tables, B, N, H, L, P, int(bool(align_corners)), bins)
    with torch.cuda.device(pts.device):
        s = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msda_stream_bin"] += 1
        _raise("msda_stream_count_launch", lib.msda_stream_count_launch(
            pts.data_ptr(), counts.data_ptr(), *geometry, s))
        _raise("msda_stream_scan_launch", lib.msda_stream_scan_launch(
            counts.data_ptr(), starts.data_ptr(), cursor.data_ptr(),
            staged.data_ptr(), *tables, B, H, L, P, bins, s))
        _raise("msda_stream_scatter_launch", lib.msda_stream_scatter_launch(
            pts.data_ptr(), wts.data_ptr(), cursor.data_ptr(),
            records.data_ptr(), *geometry, s))
    return records, starts, counts, staged


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
    records, starts, counts, staged = bin_samples(pts, wts, shapes, plan,
                                                  align_corners)
    tiles = (ctypes.c_int * (2 * L))(*(v for p in plan for v in p))
    lib = load()
    with torch.cuda.device(img.device):
        s = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msda_stream_fwd"] += 1
        _raise("msda_stream_fwd_launch", lib.msda_stream_fwd_launch(
            DTYPE_CODES[img.dtype], img.data_ptr(), records.data_ptr(),
            starts.data_ptr(), counts.data_ptr(), staged.data_ptr(),
            out.data_ptr(),
            ctypes.addressof(level_hw), ctypes.addressof(tiles), B, I, N, H,
            C, L, P, int(padding_mode == "zeros"), int(bool(align_corners)),
            counts.numel(), s))
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
    records, starts, counts, staged = bin_samples(pts, wts, shapes, plan,
                                                  align_corners)
    tiles = (ctypes.c_int * (2 * L))(*(v for p in plan for v in p))
    lib = load()
    img_grad = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    pts_grad = torch.empty(pts.shape, dtype=torch.float32, device=img.device)
    wts_grad = torch.empty(wts.shape, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        s = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msda_stream_bwd"] += 1
        _raise("msda_stream_bwd_launch", lib.msda_stream_bwd_launch(
            DTYPE_CODES[img.dtype], img.data_ptr(), out_grad.data_ptr(),
            records.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            staged.data_ptr(), img_grad.data_ptr(), pts_grad.data_ptr(),
            wts_grad.data_ptr(),
            ctypes.addressof(level_hw), ctypes.addressof(tiles), B, I, N, H,
            C, L, P, int(padding_mode == "zeros"), int(bool(align_corners)),
            counts.numel(), s))
    return (img_grad.to(img.dtype),
            pts_grad.to(sampling_points.dtype),
            wts_grad.to(attention_weights.dtype))
