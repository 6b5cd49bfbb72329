"""Plain PyTorch version of multiscale deformable attention.

The counterpart of ``msda_tpu/ops/reference.py``: a gather-based
implementation of the MSDA op of Deformable DETR (arXiv:2010.04159) that
runs on any device, in f32 or f64, and is differentiable through plain
autograd.  It is the semantics specification of the port: the CUDA kernel
(``cuda_fwd.py``) is held against it, on the CPU by the tests and on the
card by ``chip_smoke.py``.

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
    if padding_mode not in ("border", "zeros"):
        raise ValueError(
            f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}"
        )
    B, I, H, C = img.shape  # noqa: E741
    _, N, _, L, P, _ = sampling_points.shape
    device = img.device

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

    # img laid out [B, H, I, C] so the gather axis is contiguous per (b, h)
    img_t = img.permute(0, 2, 1, 3)

    def gather(yc, xc):
        """Gather img rows at the flat pyramid index per point -> [B,N,H,L,P,C]."""
        idx = offs + yc * wi + xc  # [B, N, H, L, P]
        idx_t = idx.permute(0, 2, 1, 3, 4).reshape(B, H, N * L * P, 1)
        g = torch.gather(img_t, 2, idx_t.expand(B, H, N * L * P, C))
        return g.reshape(B, H, N, L, P, C).permute(0, 2, 1, 3, 4, 5)

    v00 = gather(y0c, x0c)
    v01 = gather(y0c, x1c)
    v10 = gather(y1c, x0c)
    v11 = gather(y1c, x1c)

    one = torch.ones((), dtype=compute_dtype, device=device)
    if padding_mode == "zeros":
        # a corner is valid iff its *unclamped* index lies inside the level
        mx0 = ((x0i >= 0) & (x0i < wi)).to(compute_dtype)[..., None]
        mx1 = ((x1i >= 0) & (x1i < wi)).to(compute_dtype)[..., None]
        my0 = ((y0i >= 0) & (y0i < hi)).to(compute_dtype)[..., None]
        my1 = ((y1i >= 0) & (y1i < hi)).to(compute_dtype)[..., None]
        w00 = my0 * mx0
        w01 = my0 * mx1
        w10 = my1 * mx0
        w11 = my1 * mx1
    else:
        w00 = w01 = w10 = w11 = one

    c00 = w00 * (1.0 - dy) * (1.0 - dx)
    c01 = w01 * (1.0 - dy) * dx
    c10 = w10 * dy * (1.0 - dx)
    c11 = w11 * dy * dx

    samples = (
        v00.to(compute_dtype) * c00
        + v01.to(compute_dtype) * c01
        + v10.to(compute_dtype) * c10
        + v11.to(compute_dtype) * c11
    )  # [B, N, H, L, P, C]

    out = torch.einsum(
        "bnhlpc,bnhlp->bnhc", samples, attention_weights.to(compute_dtype)
    )
    return out.to(img.dtype)
