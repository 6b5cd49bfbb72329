"""Multiscale deformable attention in plain PyTorch: the reference of the
benchmark (Deformable DETR, arXiv:2010.04159, eq. 3), written from the
paper and ``grid_sample``'s conventions, with nothing of the program.

Shapes: ``img`` ``[B, I, H, C]`` (the flattened pyramid), ``shapes`` the
levels' ``(h, w)``, ``pts`` ``[B, N, H, L, P, 2]`` normalized (x, y),
``wts`` ``[B, N, H, L, P]``; the result is ``[B, N, H, C]``.  A point at
pixel coordinates ``x = pt_x * w - 0.5`` (``pt_x * (w - 1)`` with
``align_corners``) reads its four neighbours with bilinear weights;
``"border"`` clamps a neighbour into the level, ``"zeros"`` drops one
outside it.
"""

from __future__ import annotations

import torch


def corners(shapes, pts, padding_mode="border", align_corners=False,
            dtype=None):
    """The four neighbours of every point: a list of ``(flat index,
    weight, d weight / d x, d weight / d y)``, ``[B, N, H, L, P]`` each,
    ``x`` and ``y`` in pixels.  The pixel coordinates and their floor are
    taken in the points' dtype (at least f32), a product and a difference
    each rounded once, as the op defines them; the weights are then
    computed in ``dtype`` (the same by default)."""
    dev = pts.device
    dt = torch.promote_types(pts.dtype, torch.float32)
    pts = pts.to(dt)
    h = torch.tensor([s[0] for s in shapes], device=dev).view(1, 1, 1, -1, 1)
    w = torch.tensor([s[1] for s in shapes], device=dev).view(1, 1, 1, -1, 1)
    start = torch.tensor([0] + [a * b for a, b in shapes][:-1],
                         device=dev).cumsum(0).view(1, 1, 1, -1, 1)
    if align_corners:
        x = pts[..., 0] * (w - 1).to(dt)
        y = pts[..., 1] * (h - 1).to(dt)
    else:
        x = pts[..., 0] * w.to(dt) - 0.5
        y = pts[..., 1] * h.to(dt) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).to(dtype or dt), (y - y0).to(dtype or dt)
    x0, y0 = x0.long(), y0.long()
    out = []
    for cy, cx, wy, wx, sy, sx in (
            (y0, x0, 1 - fy, 1 - fx, -1, -1), (y0, x0 + 1, 1 - fy, fx, -1, 1),
            (y0 + 1, x0, fy, 1 - fx, 1, -1), (y0 + 1, x0 + 1, fy, fx, 1, 1)):
        inside = ((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)).to(fx.dtype)
        keep = inside if padding_mode == "zeros" else torch.ones_like(inside)
        idx = start + cy.clamp(0).minimum(h - 1) * w + cx.clamp(0).minimum(
            w - 1)
        out.append((idx, keep * wy * wx, keep * wy * sx, keep * sy * wx))
    return out


def _gather(img_t, idx):
    """``img_t`` ``[B, H, I, C]`` at ``idx`` ``[B, N, H, L, P]``:
    ``[B, N, H, L, P, C]``."""
    B, N, H, L, P = idx.shape
    C = img_t.shape[-1]
    flat = idx.permute(0, 2, 1, 3, 4).reshape(B, H, N * L * P, 1)
    got = torch.gather(img_t, 2, flat.expand(B, H, N * L * P, C))
    return got.view(B, H, N, L, P, C).permute(0, 2, 1, 3, 4, 5)


def msda(img, shapes, pts, wts, padding_mode="border", align_corners=False):
    """The op's forward in ``img``'s dtype, differentiable by autograd in
    every input."""
    img_t = img.permute(0, 2, 1, 3)
    out = 0
    for idx, w, _, _ in corners(shapes, pts, padding_mode, align_corners):
        out = out + torch.einsum("bnhlpc,bnhlp->bnhc", _gather(img_t, idx),
                                 (w * wts).to(img.dtype))
    return out


@torch.no_grad()
def msda_with_grads(img, shapes, pts, wts, out_grad, padding_mode="border",
                    align_corners=False, dtype=torch.float64,
                    chunk: int = 4096):
    """The op's output and its three input gradients for ``out_grad``,
    computed in ``dtype`` a block of ``chunk`` queries at a time (so that a
    large pyramid fits), the gradients written out by the chain rule:
    ``(out, img_grad, pts_grad, wts_grad)``."""
    B, I, H, C = img.shape  # noqa: E741
    N = pts.shape[1]
    img_t = img.to(dtype).permute(0, 2, 1, 3).contiguous()
    img_grad = torch.zeros_like(img_t)  # [B, H, I, C]
    out = torch.empty((B, N, H, C), dtype=dtype, device=img.device)
    pts_grad = torch.empty(pts.shape, dtype=dtype, device=img.device)
    wts_grad = torch.empty(wts.shape, dtype=dtype, device=img.device)
    hw = torch.tensor(shapes, dtype=dtype, device=img.device)
    scale = hw - 1 if align_corners else hw  # d pixel / d normalized, (h, w)
    for n0 in range(0, N, chunk):
        p = pts[:, n0:n0 + chunk]
        a = wts[:, n0:n0 + chunk].to(dtype)
        g = out_grad[:, n0:n0 + chunk].to(dtype)  # [B, n, H, C]
        n = p.shape[1]
        acc = torch.zeros((B, n, H, C), dtype=dtype, device=img.device)
        dw = torch.zeros(a.shape, dtype=dtype, device=img.device)
        dx = torch.zeros(a.shape, dtype=dtype, device=img.device)
        dy = torch.zeros(a.shape, dtype=dtype, device=img.device)
        for idx, w, wx, wy in corners(shapes, p, padding_mode, align_corners,
                                      dtype):
            v = _gather(img_t, idx)  # [B, n, H, L, P, C]
            acc += torch.einsum("bnhlpc,bnhlp->bnhc", v, w * a)
            gv = torch.einsum("bnhlpc,bnhc->bnhlp", v, g)
            dw += w * gv
            dx += wx * gv
            dy += wy * gv
            src = (w * a)[..., None] * g[:, :, :, None, None, :]
            L, P = a.shape[3:]
            flat = idx.permute(0, 2, 1, 3, 4).reshape(B, H, n * L * P, 1)
            img_grad.scatter_add_(
                2, flat.expand(B, H, n * L * P, C),
                src.permute(0, 2, 1, 3, 4, 5).reshape(B, H, n * L * P, C))
        out[:, n0:n0 + n] = acc
        wts_grad[:, n0:n0 + n] = dw
        pts_grad[:, n0:n0 + n, ..., 0] = a * dx * scale[:, 1].view(
            1, 1, 1, -1, 1)
        pts_grad[:, n0:n0 + n, ..., 1] = a * dy * scale[:, 0].view(
            1, 1, 1, -1, 1)
    return out, img_grad.permute(0, 2, 1, 3), pts_grad, wts_grad
