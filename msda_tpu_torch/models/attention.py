"""MultiscaleDeformableAttention module (PyTorch).

The counterpart of ``msda_tpu/models/attention.py``: three projections
(img input, query input producing per-point offsets and weight logits, query
output), a softmax over the flattened (levels x points) axis, and 2- or
4-coordinate reference points.  The projections are ``nn.Linear``s whose
``state_dict`` keys (``img_input_proj`` / ``query_input_proj`` /
``query_output_proj``) are msda-triton's.

Known reference quirk, kept deliberately: for 2-coordinate reference points
msda-triton divides the (x, y) offsets by ``img_shapes``, which is in
**(height, width)** order, so x-offsets are normalized by the height and
y-offsets by the width.  ``offset_normalizer="reference"`` (default) keeps
that; ``offset_normalizer="detr"`` uses the original paper's (w, h) order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import level_shapes, multiscale_deformable_attention

__all__ = ["Dense", "MultiscaleDeformableAttention"]


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s dtype policy.

    With ``compute_dtype`` set, input, weight and bias are cast to it and the
    product is computed and returned in it (f32 master weights, half
    precision activations).  Without it, the input and the weight are
    promoted to their common dtype.
    """

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype | None = None, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MultiscaleDeformableAttention(nn.Module):
    """Multiscale deformable attention with input/output projections.

    See Figure 2 of https://arxiv.org/pdf/2010.04159 for the op.

    Args:
        emb_dim: feature dimension of inputs/outputs.
        hidden_dim: projected feature dimension; must be divisible by
            ``num_heads``.
        num_levels: number of feature pyramid levels.
        num_heads: number of attention heads.
        num_points: sampling points per head per level.
        padding_mode: "border" or "zeros" out-of-bounds handling.
        align_corners: grid alignment (see grid_sample docs).
        offset_normalizer: "reference" (msda-triton's (h, w) order) or
            "detr" (the original paper's (w, h)).
        impl: forwarded to :func:`multiscale_deformable_attention`.
        compute_dtype: ``None`` or ``torch.bfloat16``: the projections and
            the projected pyramid run in it; the sampling-point and weight
            math stays in at least f32.
        device: where the parameters are made.
    """

    def __init__(
        self,
        emb_dim: int,
        hidden_dim: int,
        num_levels: int,
        num_heads: int,
        num_points: int,
        padding_mode: str = "border",
        align_corners: bool = False,
        offset_normalizer: str = "reference",
        impl: str = "auto",
        compute_dtype: torch.dtype | None = None,
        device=None,
    ):
        super().__init__()
        if hidden_dim % num_heads != 0:
            raise ValueError(
                f"Hidden dimension (hidden_dim={hidden_dim}) should be "
                f"divisible by number of heads (num_heads={num_heads})."
            )
        if offset_normalizer not in ("reference", "detr"):
            raise ValueError(
                "offset_normalizer must be 'reference' or 'detr', got "
                f"{offset_normalizer!r}"
            )
        self.emb_dim = emb_dim
        self.hidden_dim = hidden_dim
        self.num_levels = num_levels
        self.num_heads = num_heads
        self.num_points = num_points
        self.padding_mode = padding_mode
        self.align_corners = align_corners
        self.offset_normalizer = offset_normalizer
        self.impl = impl
        H, L, P = num_heads, num_levels, num_points
        self.img_input_proj = Dense(emb_dim, hidden_dim, compute_dtype, device)
        self.query_input_proj = Dense(emb_dim, H * L * P * 3, compute_dtype,
                                      device)
        self.query_output_proj = Dense(hidden_dim, emb_dim, compute_dtype,
                                       device)

    def forward(self, img, img_shapes, queries, reference_points):
        """Args:
            img: ``[B, I, emb_dim]`` flattened feature pyramid.
            img_shapes: ``[L, 2]`` integer (height, width) per level.
            queries: ``[B, N, emb_dim]`` latent queries.
            reference_points: ``[B, N, 2]`` normalized (x, y) positions or
                ``[B, N, 4]`` normalized (cx, cy, w, h) boxes.

        Returns:
            ``[B, N, emb_dim]``.
        """
        B, I, _ = img.shape  # noqa: E741
        N = queries.shape[1]
        H, L, P = self.num_heads, self.num_levels, self.num_points
        C = self.hidden_dim

        # offsets and attention logits in at least f32 even under bf16:
        # bf16's 8 mantissa bits would quantize absolute sampling positions
        # to ~1/256 of a level (promote, so that f64 stays f64)
        q = self.query_input_proj(queries)
        q = q.to(torch.promote_types(q.dtype, torch.float32))
        q = q.reshape(B, N, H, L, P, 3)
        offsets, logits = q[..., :2], q[..., 2]
        attention_weights = torch.softmax(
            logits.reshape(B, N, H, L * P), dim=-1
        ).reshape(B, N, H, L, P)

        img_p = self.img_input_proj(img).reshape(B, I, H, C // H)

        shapes = level_shapes(img_shapes)
        last = reference_points.shape[-1]
        if last == 2:
            hw = torch.tensor(shapes, dtype=offsets.dtype,
                              device=offsets.device)  # (h, w) order
            normalizer = hw if self.offset_normalizer == "reference" else (
                hw.flip(-1))
            # [B, N, 1, 1, 1, 2] + [B, N, H, L, P, 2] / [L, 1, 2]
            sampling_points = (
                reference_points[:, :, None, None, None, :]
                + offsets / normalizer[:, None, :]
            )
        elif last == 4:
            # box-scaled offsets
            sampling_points = (
                reference_points[:, :, None, None, None, :2]
                + offsets
                * reference_points[:, :, None, None, None, 2:]
                / (2 * P)
            )
        else:
            raise ValueError(
                "`reference_points` should have last dim 2 or 4, "
                f"but got {last}."
            )

        out = multiscale_deformable_attention(
            img_p, shapes, sampling_points, attention_weights,
            self.padding_mode, self.align_corners, impl=self.impl,
        )
        return self.query_output_proj(out.reshape(B, N, C))
