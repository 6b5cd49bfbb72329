"""Plain PyTorch version of multiscale deformable attention.

The counterpart of ``msda_tpu/ops/reference.py``: a gather-based
implementation of the MSDA op of Deformable DETR (arXiv:2010.04159) that
runs on any device, in f32 or f64, and is differentiable through plain
autograd.  It is the semantics specification of the port: the CUDA kernel
(``cuda_fwd.py``) is held against it, on the CPU by the tests and on the
card by ``chip_smoke.py``.  ``native_msda_backward`` is the plain version
of the backward kernel (``cuda_bwd.py``, K2): autograd through this forward.

It computes flat pyramid indices for the four bilinear corners of every
sampling point and does four batched gathers over the flattened pixel axis.
``padding_mode`` in {"border", "zeros"} and ``align_corners`` match
``torch.nn.functional.grid_sample``: coordinates are unnormalized by
``align_corners``, floored, the zeros-mode masks are taken on the
*unclamped* corner indices, and the indices are clamped afterwards.

Notation:
    img:                [B, I, H, C]          flattened feature pyramid
    img_shapes:         [L, 2]                per-level (height, width)
    sampling_points:    [B, N, H, L, P, 2]    normalized (x, y) in [0, 1]
    attention_weights:  [B, N, H, L, P]
    output:             [B, N, H, C]
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "level_shapes",
    "native_multiscale_deformable_attention",
    "native_msda_backward",
    "compute_level_data",
]


def level_shapes(img_shapes) -> tuple[tuple[int, int], ...]:
    """``img_shapes`` as a host tuple ``((h, w), ...)`` of Python ints.

    Accepts a sequence of pairs, a numpy array or an integer tensor (on any
    device: a device tensor is copied to the host once, here).  Callers
    that run many ops on one pyramid convert once and pass the tuple on.
    """
    if isinstance(img_shapes, tuple) and all(
        isinstance(s, tuple) and len(s) == 2
        and all(isinstance(v, int) for v in s)
        for s in img_shapes
    ):
        return img_shapes
    if isinstance(img_shapes, torch.Tensor):
        img_shapes = img_shapes.detach().cpu().numpy()
    arr = np.asarray(img_shapes)
    if arr.ndim != 2 or arr.shape[-1] != 2:
        raise ValueError(f"`img_shapes` must be [L, 2], got shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        if not np.array_equal(arr, np.round(arr)):
            raise ValueError(
                f"`img_shapes` must hold integer sizes, got {arr.tolist()}"
            )
    return tuple((int(h), int(w)) for h, w in arr)


def compute_level_data(img_shapes, dtype=torch.float32, device=None):
    """Split ``img_shapes`` into per-level heights, widths and flat offsets.

    Returns float heights and widths of shape [L] in ``dtype`` and int64
    flat start offsets of shape [L] into the flattened pixel axis.
    """
    shapes = level_shapes(img_shapes)
    hw = torch.tensor(shapes, dtype=torch.int64, device=device).reshape(-1, 2)
    sizes = hw[:, 0] * hw[:, 1]
    level_offsets = torch.cumsum(sizes, 0) - sizes
    return hw[:, 0].to(dtype), hw[:, 1].to(dtype), level_offsets


def _unnormalize(coord, extent, align_corners):
    """Map [0, 1]-normalized coords to pixel coords, grid_sample-style.

    align_corners=True:  x_pix = x * (W - 1)
    align_corners=False: x_pix = x * W - 0.5
    """
    if align_corners:
        return coord * (extent - 1.0)
    return coord * extent - 0.5


def _geometry(img_shapes, sampling_points, padding_mode, align_corners,
              device):
    """The bilinear corners of every sampling point, in the points' dtype
    (at least f32): flat pyramid indices of the four corners
    ``[B, N, H, L, P]`` (clamped), the fractional offsets ``dx``, ``dy``
    ``[B, N, H, L, P, 1]`` (differentiable in the points) and, in zeros
    mode, the four corner masks (None in border mode)."""
    compute_dtype = torch.promote_types(sampling_points.dtype, torch.float32)
    pts = sampling_points.to(compute_dtype)

    hf, wf, level_offsets = compute_level_data(img_shapes, compute_dtype, device)
    # broadcast per-level data to [1, 1, 1, L, 1] against [B, N, H, L, P]
    hf = hf[None, None, None, :, None]
    wf = wf[None, None, None, :, None]
    hi = hf.to(torch.int64)
    wi = wf.to(torch.int64)
    offs = level_offsets[None, None, None, :, None]

    x = _unnormalize(pts[..., 0], wf, align_corners)
    y = _unnormalize(pts[..., 1], hf, align_corners)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]  # [B, N, H, L, P, 1]
    dy = (y - y0)[..., None]

    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = x0i + 1
    y1i = y0i + 1

    # border semantics = index clamping
    x0c = torch.clamp(x0i, min=0).minimum(wi - 1)
    x1c = torch.clamp(x1i, min=0).minimum(wi - 1)
    y0c = torch.clamp(y0i, min=0).minimum(hi - 1)
    y1c = torch.clamp(y1i, min=0).minimum(hi - 1)
    corners = tuple(offs + yc * wi + xc for yc, xc in
                    ((y0c, x0c), (y0c, x1c), (y1c, x0c), (y1c, x1c)))

    masks = None
    if padding_mode == "zeros":
        # a corner is valid iff its *unclamped* index lies inside the level
        mx0 = ((x0i >= 0) & (x0i < wi))[..., None]
        mx1 = ((x1i >= 0) & (x1i < wi))[..., None]
        my0 = ((y0i >= 0) & (y0i < hi))[..., None]
        my1 = ((y1i >= 0) & (y1i < hi))[..., None]
        masks = (my0, mx0, my1, mx1)
    return corners, dx, dy, masks


def _interpolate(img, geometry, attention_weights, dtype):
    """Gather the four corners of every point and sum the weighted bilinear
    samples in ``dtype``: ``[B, N, H, C]``."""
    corners, dx, dy, masks = geometry
    B, _, H, C = img.shape
    _, N, _, L, P = corners[0].shape
    dx = dx.to(dtype)
    dy = dy.to(dtype)

    # img laid out [B, H, I, C] so the gather axis is contiguous per (b, h)
    img_t = img.permute(0, 2, 1, 3)

    def gather(idx):
        """Gather img rows at the flat pyramid index per point -> [B,N,H,L,P,C]."""
        idx_t = idx.permute(0, 2, 1, 3, 4).reshape(B, H, N * L * P, 1)
        g = torch.gather(img_t, 2, idx_t.expand(B, H, N * L * P, C))
        return g.reshape(B, H, N, L, P, C).permute(0, 2, 1, 3, 4, 5)

    v00, v01, v10, v11 = (gather(idx) for idx in corners)

    if masks is not None:
        my0, mx0, my1, mx1 = (m.to(dtype) for m in masks)
        w00 = my0 * mx0
        w01 = my0 * mx1
        w10 = my1 * mx0
        w11 = my1 * mx1
    else:
        w00 = w01 = w10 = w11 = torch.ones((), dtype=dtype, device=img.device)

    c00 = w00 * (1.0 - dy) * (1.0 - dx)
    c01 = w01 * (1.0 - dy) * dx
    c10 = w10 * dy * (1.0 - dx)
    c11 = w11 * dy * dx

    samples = (
        v00.to(dtype) * c00
        + v01.to(dtype) * c01
        + v10.to(dtype) * c10
        + v11.to(dtype) * c11
    )  # [B, N, H, L, P, C]

    return torch.einsum(
        "bnhlpc,bnhlp->bnhc", samples, attention_weights.to(dtype)
    )


def _check_padding(padding_mode):
    if padding_mode not in ("border", "zeros"):
        raise ValueError(
            f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}"
        )


def native_multiscale_deformable_attention(
    img,
    img_shapes,
    sampling_points,
    attention_weights,
    padding_mode: str = "border",
    align_corners: bool = False,
):
    """Gather-based multiscale deformable attention (any device).

    Args:
        img: ``[B, I, H, C]`` flattened feature pyramid where
            ``I = sum(h_l * w_l)``.
        img_shapes: ``[L, 2]`` integer (height, width) per pyramid level.
        sampling_points: ``[B, N, H, L, P, 2]`` normalized (x, y) in [0, 1];
            (0, 0) is the top-left corner, (1, 1) the bottom-right.
        attention_weights: ``[B, N, H, L, P]``.
        padding_mode: "border" clamps out-of-bounds samples to the nearest
            pixel, "zeros" zeroes them (grid_sample semantics).
        align_corners: grid alignment, see ``torch.nn.functional.grid_sample``.

    Returns:
        ``[B, N, H, C]`` attention-weighted bilinear samples in ``img.dtype``.
        The arithmetic runs in f32 (f64 for f64 points) whatever the storage
        dtype.
    """
    _check_padding(padding_mode)
    compute_dtype = torch.promote_types(sampling_points.dtype, torch.float32)
    geometry = _geometry(img_shapes, sampling_points, padding_mode,
                         align_corners, img.device)
    out = _interpolate(img, geometry, attention_weights, compute_dtype)
    return out.to(img.dtype)


def native_msda_backward(
    img,
    img_shapes,
    sampling_points,
    attention_weights,
    out_grad,
    padding_mode: str = "border",
    align_corners: bool = False,
):
    """The three input gradients of the plain version for ``out_grad``.

    The gradient of the plain forward, written out: the plain version of
    the backward kernel K2, for the tests, ``chip_smoke.py`` and the CPU
    implementation of ``torch.ops.msda_tpu_torch.msda_bwd``.  The sampling
    geometry (corners, ``dx``, ``dy``) is the forward's, computed in the
    points' dtype; everything after it (the gathers, the bilinear sums over
    channels, the gradients) runs in f64, and each gradient is rounded once
    to its input's dtype, the point gradients after the chain rule's last
    step (``d dx / d x`` = the level's width or ``width - 1``), taken in
    the points' compute dtype as autograd takes it.  So the result is the
    gradient of the function the forward computes, as
    ``torch.autograd.grad`` through it in f64 gives it (the tests hold the
    two together).  It calls no autograd, so that it also runs inside an
    operator's implementation, where a dispatch mode (``opcheck``'s schema
    check) has turned autograd off.  (At Deformable DETR's widths, the point
    gradients are sums over channels of terms as large as ``level width *
    |out_grad * img|``, and an f32 sum of them, in any order, keeps only
    about 5e-5 of the result.)  Returns ``(img_grad, sampling_points_grad,
    attention_weights_grad)``.
    """
    _check_padding(padding_mode)
    f64 = torch.float64
    compute_dtype = torch.promote_types(sampling_points.dtype, torch.float32)
    shapes = level_shapes(img_shapes)
    corners, dx, dy, masks = _geometry(shapes, sampling_points, padding_mode,
                                       align_corners, img.device)
    B, I, H, C = img.shape  # noqa: E741
    _, N, _, L, P = corners[0].shape
    dx, dy = dx.to(f64), dy.to(f64)  # [B, N, H, L, P, 1]
    img_t = img.permute(0, 2, 1, 3).to(f64)  # [B, H, I, C]

    def flat(idx):  # [B, N, H, L, P] -> [B, H, N*L*P, C] gather index
        idx = idx.permute(0, 2, 1, 3, 4).reshape(B, H, N * L * P, 1)
        return idx.expand(B, H, N * L * P, C)

    def unflat(t):  # [B, H, N*L*P, C] -> [B, N, H, L, P, C]
        return t.reshape(B, H, N, L, P, C).permute(0, 2, 1, 3, 4, 5)

    values = [unflat(torch.gather(img_t, 2, flat(i))) for i in corners]
    if masks is None:
        w00 = w01 = w10 = w11 = torch.ones((), dtype=f64, device=img.device)
    else:
        my0, mx0, my1, mx1 = (m.to(f64) for m in masks)
        w00, w01, w10, w11 = my0 * mx0, my0 * mx1, my1 * mx0, my1 * mx1
    lerp = (w00 * (1.0 - dy) * (1.0 - dx), w01 * (1.0 - dy) * dx,
            w10 * dy * (1.0 - dx), w11 * dy * dx)
    # d lerp / d dx and d lerp / d dy, corner by corner
    d_dx = (-w00 * (1.0 - dy), w01 * (1.0 - dy), -w10 * dy, w11 * dy)
    d_dy = (-w00 * (1.0 - dx), -w01 * dx, w10 * (1.0 - dx), w11 * dx)

    og = out_grad.to(f64)[:, :, :, None, None, :]  # [B, N, H, 1, 1, C]
    a = attention_weights.to(f64)[..., None]  # [B, N, H, L, P, 1]
    og_v = [(og * v).sum(-1, keepdim=True) for v in values]
    wts_grad = sum(c * g for c, g in zip(lerp, og_v))[..., 0]
    g_dx = a * sum(c * g for c, g in zip(d_dx, og_v))
    g_dy = a * sum(c * g for c, g in zip(d_dy, og_v))

    img_grad = torch.zeros((B, H, I, C), dtype=f64, device=img.device)
    ao = a * og  # [B, N, H, L, P, C]
    for idx, c in zip(corners, lerp):
        src = (ao * c).permute(0, 2, 1, 3, 4, 5).reshape(B, H, N * L * P, C)
        img_grad.scatter_add_(2, flat(idx), src)

    # x = pt * extent - 0.5 (or pt * (extent - 1)), dx = x - floor(x)
    hf, wf, _ = compute_level_data(shapes, compute_dtype, img.device)
    if align_corners:
        hf, wf = hf - 1.0, wf - 1.0
    pts_grad = torch.cat(
        [g_dx.to(compute_dtype) * wf[:, None, None],
         g_dy.to(compute_dtype) * hf[:, None, None]], -1)
    return (img_grad.permute(0, 2, 1, 3).to(img.dtype).contiguous(),
            pts_grad.to(sampling_points.dtype),
            wts_grad.to(attention_weights.dtype))
