"""Wrapper of the CUDA backward kernel (K2) in ``csrc/msda_bwd.cu``.

The kernel replaces the TPU kernel ``msda_tpu/ops/pallas_bwd.py:_bwd_kernel``
(see the note at the top of the source for its design and what bounds it).
Its plain version is ``reference.native_msda_backward``.

The kernel sums the img_grad terms of a query's consecutive points on the
same four pixels of a level in registers and adds each such run once a
corner; where all of a query's points on a level fall on the same pixels,
their run is added with its rounding error kept in a second f32 buffer,
which the wrapper adds back.
:func:`plain_merged_bwd` is a plain model of that summation, for the tests:
its img_grad merges the same runs in f32 and adds them in one sequential
order, where the card's atomics take a run-dependent one.

The wrapper checks device, dtype, shape and contiguity (the checks it shares
with K1, ``cuda_fwd.check_inputs``, plus ``out_grad``'s) and raises on
anything the kernel does not take; it never falls back to the plain version.
The kernel adds ``img_grad`` with f32 atomics into a zeroed f32 buffer of
two halves (the sums and the exact adds' rounding errors), whose sum is cast
once to ``img``'s dtype; the point and weight gradients are computed
in f32 and cast to the dtypes of ``sampling_points`` and
``attention_weights``, as the JAX wrapper casts them.  The library is built
at first use (``_build.load_library``), and each launch adds one to
``LAUNCHES``.  ``launch_plan`` returns the tile, point chunks, channel
steps, copy widths, shared memory and tiles that a launch on given inputs
uses (``csrc/msda_bwd_plan.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, launches
from .cuda_fwd import DTYPE_CODES, check_inputs
from .reference import _geometry, level_shapes, native_msda_backward

__all__ = ["LAUNCHES", "msda_bwd", "load", "plain_merged_bwd",
           "launch_plan", "PLAN_FIELDS"]

KERNEL = "msda_bwd"

# Number of kernel launches since import (or since a caller reset it).
LAUNCHES = 0
launches.register(__name__)
# msda::BwdPlan's fields, in the order msda_bwd_plan writes them
PLAN_FIELDS = ("lanes", "vec", "tile", "chunk", "stride", "chunks", "steps",
               "vw_pts", "vw_wts", "smem", "tiles")


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
    img_grad = torch.zeros((2,) + tuple(img.shape), dtype=torch.float32,
                           device=img.device)
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
    return (torch.add(img_grad[0], img_grad[1]).to(img.dtype),
            pts_grad.to(sampling_points.dtype),
            wts_grad.to(attention_weights.dtype))


def launch_plan(img, img_shapes, sampling_points, attention_weights,
                out_grad) -> dict:
    """The plan of K2's launch on these inputs, ``{field: int}`` over
    ``PLAN_FIELDS``: the lanes a task and channels a lane, the tile of
    tasks a block, the points staged at once, the chunks a task, the
    channel steps a point, the floats a copy of the points and of the
    weights, the dynamic shared bytes a block and the tiles of the launch
    (``csrc/msda_bwd_plan.cuh``)."""
    _, pts, wts = check_inputs(img, img_shapes, sampling_points,
                               attention_weights, "border")
    B, N, H, L, P, _ = pts.shape
    C = img.shape[-1]
    fn = load().msda_bwd_plan
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    err = fn(DTYPE_CODES[img.dtype], img.data_ptr(), pts.data_ptr(),
             wts.data_ptr(), out_grad.data_ptr(), B, N, H, C, L, P,
             ctypes.addressof(plan))
    if err != 0:
        raise RuntimeError(f"msda_bwd_plan failed: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, plan))


def plain_merged_bwd(img, img_shapes, sampling_points, attention_weights,
                     out_grad, padding_mode: str = "border",
                     align_corners: bool = False, merge: bool = True,
                     exact_run: int | None = None):
    """The three gradients with ``img_grad`` summed as K2 sums it.

    Each (b, n, h) walks its points level by level.  With ``merge`` the
    terms ``a * lerp * out_grad`` of a run of consecutive points of a level
    on the same four pixels are summed in f32 and the run's sums added once
    a corner; without it every point adds its own.  A run of ``exact_run``
    points or more (default: P, all of a query's points on the level) is
    added exactly (the kernel keeps its add's rounding error), the others into an f32 buffer in the order of the tasks and
    their runs (on the card the order varies from run to run).  The result
    is rounded once to img's dtype.  The point and weight gradients are
    ``native_msda_backward``'s (K2 computes them with f64 channel sums
    too)."""
    shapes = level_shapes(img_shapes)
    _, pts_grad, wts_grad = native_msda_backward(
        img.float(), shapes, sampling_points, attention_weights,
        out_grad.float(), padding_mode, align_corners)
    corners, dx, dy, masks = _geometry(shapes, sampling_points, padding_mode,
                                       align_corners, img.device)
    f32 = torch.float32
    B, I, H, C = img.shape  # noqa: E741
    dx, dy = dx[..., 0].to(f32), dy[..., 0].to(f32)
    vx0, vx1, uy0, uy1 = 1.0 - dx, dx, 1.0 - dy, dy
    if masks is not None:
        my0, mx0, my1, mx1 = (m[..., 0].to(f32) for m in masks)
        vx0, vx1, uy0, uy1 = vx0 * mx0, vx1 * mx1, uy0 * my0, uy1 * my1
    a = attention_weights.to(f32)
    w = torch.stack([a * (uy0 * vx0), a * (uy0 * vx1), a * (uy1 * vx0),
                     a * (uy1 * vx1)], -1)  # [B, N, H, L, P, 4]
    og = out_grad.to(f32)[:, :, :, None, None, None, :]
    idx = torch.stack(corners, -1)  # [B, N, H, L, P, 4]
    terms = w[..., None] * og  # [B, N, H, L, P, 4, C]
    # a run: consecutive points of a level on the same four pixels (the
    # top-left and bottom-right corners fix them)
    start = torch.ones(idx.shape[:-1], dtype=torch.bool, device=img.device)
    if merge:
        key = idx[..., 0] * I + idx[..., 3]
        start[..., 1:] = key[..., 1:] != key[..., :-1]
    run = torch.cumsum(start.to(torch.int64), -1) - 1  # [B, N, H, L, P]
    length = torch.zeros_like(run).scatter_add_(-1, run,
                                                torch.ones_like(run))
    P = idx.shape[-2]
    exact_run = P if exact_run is None else exact_run
    exact = length.gather(-1, run)[start] >= exact_run  # [runs]
    run = run[..., None, None].expand_as(terms)
    sums = torch.zeros_like(terms).scatter_add_(4, run, terms)
    sums = sums.gather(4, run)[start].reshape(-1, C)  # [runs * 4, C]
    b = torch.arange(B, device=img.device)[:, None, None, None, None]
    h = torch.arange(H, device=img.device)[None, None, :, None, None]
    bh = (b * H + h).expand(start.shape)[start]
    target = (bh[:, None] * I + idx[start]).reshape(-1)
    exact = exact[:, None].expand(-1, 4).reshape(-1)
    img_grad = torch.zeros((B * H * I, C), dtype=f32, device=img.device)
    img_grad.index_add_(0, target[~exact], sums[~exact])
    img_grad = img_grad.double().index_add_(0, target[exact],
                                            sums[exact].double())
    img_grad = img_grad.reshape(B, H, I, C).permute(0, 2, 1, 3)
    return (img_grad.to(img.dtype).contiguous(), pts_grad, wts_grad)
