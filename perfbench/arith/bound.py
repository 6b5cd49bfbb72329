"""The least time an H100 could take for one MSDA call: a frozen copy of
``msda_tpu_torch.utils.bench``'s ``roofline_ms``, ``msda_bound`` and
``touched_rows`` arithmetic, kept here so that a change to the program
cannot move the yardstick.

Each input byte is counted read once and each output byte written once:
``img`` only in the pixel rows (one pixel of one (batch, head)) that the
points reach, ``img_grad`` whole; the points and weights and their
gradients in f32.  Operations are counted at the f32 rate, a multiply-add
as 2.
"""

from __future__ import annotations

import torch

from .peaks import BYTES_PER_S, F32_FLOPS

# f32 operations per (sampling point, channel) and per sampling point.  Per
# point, both ways: the geometry and the four corner weights times the
# attention weight (18).  Per channel, the forward: four corner
# multiply-adds (8).  The backward: the dot products of out_grad with the
# four corners (8) and the four img_grad terms (8); per point besides, the
# three sums from the four dot products (21) and the two scaled point
# gradients (4).
FWD_FLOPS_PER_CHANNEL, FWD_FLOPS_PER_POINT = 8, 18
BWD_FLOPS_PER_CHANNEL, BWD_FLOPS_PER_POINT = 16, 18 + 21 + 4


def roofline_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least ms for ``nbytes`` of device memory traffic and ``flops``
    f32 operations, and which of the two bounds it."""
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (
        t_flops, "operations")


def msda_bound(shapes, B: int, N: int, H: int, C: int, P: int,
               item: int = 4, backward: bool = False,
               img_rows: int | None = None) -> dict:
    """The compulsory work of one forward or backward call and its least
    time: ``{"bytes", "flops", "ms", "bound_by"}``.  ``item`` is the byte
    size of ``img``, ``out`` and their gradients; ``img_rows`` the rows the
    points reach (every row when None)."""
    L = len(shapes)
    I = sum(h * w for h, w in shapes)  # noqa: E741
    rows = B * I * H if img_rows is None else img_rows
    points = B * N * H * L * P
    img = rows * C * item
    pts, wts = points * 2 * 4, points * 4
    queries = B * N * H * C * item
    if backward:
        nbytes = img + pts + wts + queries + B * I * H * C * item + pts + wts
        flops = points * (C * BWD_FLOPS_PER_CHANNEL + BWD_FLOPS_PER_POINT)
    else:
        nbytes = img + pts + wts + queries
        flops = points * (C * FWD_FLOPS_PER_CHANNEL + FWD_FLOPS_PER_POINT)
    ms, bound_by = roofline_ms(nbytes, flops)
    return {"bytes": nbytes, "flops": flops, "ms": ms, "bound_by": bound_by}


def corners(shapes, points: torch.Tensor, padding_mode: str = "border",
            align_corners: bool = False):
    """The four bilinear corners of every point ``[B, N, H, L, P, 2]``: a
    list of ``(flat pixel index, bilinear weight, valid)`` for the corners
    (y0, x0), (y0, x1), (y1, x0), (y1, x1), as ``grid_sample`` takes them:
    the index clamped into the level, ``valid`` all True with border
    padding and the unclamped corner inside the level with zeros."""
    dev = points.device
    pts = points.to(torch.promote_types(points.dtype, torch.float32))
    hw = torch.tensor(shapes, dtype=torch.int64, device=dev)
    sizes = hw[:, 0] * hw[:, 1]
    offs = (torch.cumsum(sizes, 0) - sizes).view(1, 1, 1, -1, 1)
    hi = hw[:, 0].view(1, 1, 1, -1, 1)
    wi = hw[:, 1].view(1, 1, 1, -1, 1)
    if align_corners:
        x = pts[..., 0] * (wi - 1).to(pts.dtype)
        y = pts[..., 1] * (hi - 1).to(pts.dtype)
    else:
        x = pts[..., 0] * wi.to(pts.dtype) - 0.5
        y = pts[..., 1] * hi.to(pts.dtype) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    out = []
    for yc, xc, w in ((y0, x0, (1 - dy) * (1 - dx)),
                      (y0, x0 + 1, (1 - dy) * dx),
                      (y0 + 1, x0, dy * (1 - dx)),
                      (y0 + 1, x0 + 1, dy * dx)):
        if padding_mode == "zeros":
            valid = (xc >= 0) & (xc < wi) & (yc >= 0) & (yc < hi)
        else:
            valid = torch.ones_like(xc, dtype=torch.bool)
        idx = offs + yc.clamp(min=0).minimum(hi - 1) * wi + (
            xc.clamp(min=0).minimum(wi - 1))
        out.append((idx, w, valid))
    return out


def touched_rows(shapes, points: torch.Tensor, weights: torch.Tensor,
                 padding_mode: str = "border",
                 align_corners: bool = False) -> int:
    """The number of pixel rows of ``img`` (one pixel of one (b, h)) on
    which the result depends: the corners of every point whose bilinear
    weight, times the point's attention weight, is not zero."""
    B, _, H = points.shape[:3]
    I = sum(h * w for h, w in shapes)  # noqa: E741
    dev = points.device
    b = torch.arange(B, device=dev).view(B, 1, 1, 1, 1)
    h = torch.arange(H, device=dev).view(1, 1, H, 1, 1)
    keys = []
    for idx, w, valid in corners(shapes, points, padding_mode, align_corners):
        need = valid & (w * weights != 0)
        keys.append(((b * I + idx) * H + h)[need])
    return int(torch.unique(torch.cat(keys)).numel())
