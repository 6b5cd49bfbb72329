"""Operations of the DINO forward in training, from a configuration's
shapes and a batch's number of denoising queries alone (a multiply-add
counts 2), in ``flops``'s terms: every matrix product and the MSDA op's
sampling, normalisations, softmaxes, activations, the sine embeddings and
the top-k left out.

Counted: the input projections and the encoder (``flops``), the proposal
stage over every token (``enc_output`` D x D, the class head D x K, the
3-layer box MLP D x D, D x D, D x 4), and each decoder layer over its
``num_queries + pad`` queries: ``ref_point_head`` (2D x D, D x D), the
self-attention with its score and value products, the deformable
attention, the FFN, the class head and the box MLP twice (the prediction
and the reference's update; once in the last layer)."""

from __future__ import annotations

from ..inputs import level_shapes
from .flops import _linear, _msda


def dino_forward_flops(cfg: dict, B: int, hw, pad: float) -> float:
    """One forward of a batch of ``B`` images of ``hw`` pixels with ``pad``
    denoising queries an image (a mean may be fractional)."""
    D, F, K, H = (cfg["emb_dim"], cfg["ffn_dim"], cfg["num_classes"],
                  cfg["num_heads"])
    shapes = level_shapes(cfg, hw)
    I = sum(h * w for h, w in shapes)  # noqa: E741
    N = cfg["num_queries"] + pad
    total = sum(_linear(B * h * w, c, D)
                for (h, w), c in zip(shapes, cfg["in_channels"]))
    ffn = _linear(1, D, F) + _linear(1, F, D)
    total += cfg["num_encoder_layers"] * (_msda(cfg, B, I, I) + B * I * ffn)
    box_mlp = _linear(1, D, D) * 2 + _linear(1, D, 4)
    total += B * I * (_linear(1, D, D) + _linear(1, D, K) + box_mlp)
    layers = cfg["num_decoder_layers"]
    self_attn = 4 * _linear(B * N, D, D) + 2 * 2 * B * H * N * N * (D // H)
    ref_head = _linear(1, 2 * D, D) + _linear(1, D, D)
    total += layers * (self_attn + _msda(cfg, B, N, I)
                       + B * N * (ffn + ref_head + _linear(1, D, K)))
    total += (2 * layers - 1) * B * N * box_mlp
    return total
