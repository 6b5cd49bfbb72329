"""Operation counts of the Deformable DETR forward, from a configuration's
shapes alone (a multiply-add counts 2).

Counted: every matrix product (the input projections, the encoder and
decoder layers' projections and FFNs, the decoder's self-attention with
its score and value products, the heads) and the MSDA op's sampling
(``bound.FWD_FLOPS_*`` a point).  Not counted: normalisations, softmaxes,
activations and the post-processing, a few percent of the total.  A
training step counts three forwards.
"""

from __future__ import annotations

from ..inputs import level_shapes
from .bound import FWD_FLOPS_PER_CHANNEL, FWD_FLOPS_PER_POINT


def _linear(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def _msda(cfg: dict, B: int, N: int, I: int) -> int:  # noqa: E741
    """One deformable attention module over ``N`` queries and ``I``
    pixels: the value projection over the pyramid, the offset and weight
    projection, the sampling and the output projection."""
    D, H, L, P = (cfg["emb_dim"], cfg["num_heads"], cfg["num_levels"],
                  cfg["num_points"])
    C = D // H
    points = B * N * H * L * P
    return (_linear(B * I, D, D) + _linear(B * N, D, H * L * P * 3)
            + points * (C * FWD_FLOPS_PER_CHANNEL + FWD_FLOPS_PER_POINT)
            + _linear(B * N, D, D))


def detector_forward_flops(cfg: dict, B: int, hw) -> int:
    """Operations of one forward of a batch of ``B`` images of ``hw``
    pixels."""
    D, F, Q, K = (cfg["emb_dim"], cfg["ffn_dim"], cfg["num_queries"],
                  cfg["num_classes"])
    H = cfg["num_heads"]
    shapes = level_shapes(cfg, hw)
    I = sum(h * w for h, w in shapes)  # noqa: E741
    total = sum(_linear(B * h * w, c, D)
                for (h, w), c in zip(shapes, cfg["in_channels"]))
    ffn = _linear(1, D, F) + _linear(1, F, D)
    total += cfg["num_encoder_layers"] * (_msda(cfg, B, I, I) + B * I * ffn)
    self_attn = 4 * _linear(B * Q, D, D) + 2 * 2 * B * H * Q * Q * (D // H)
    total += cfg["num_decoder_layers"] * (
        self_attn + _msda(cfg, B, Q, I) + B * Q * ffn)
    heads = cfg["num_decoder_layers"] if cfg["with_box_refinement"] else 1
    total += heads * (_linear(B * Q, D, K) + _linear(B * Q, D, 4))
    return total
