"""Operations of the published two-stage Deformable DETR forward, from a
configuration's shapes alone (a multiply-add counts 2): the detector's
(``flops.detector_forward_flops``) and the proposal stage's matrix
products, ``enc_output`` (D x D), the encoder's class head (D x K) and box
head (D x 4) over every token, and ``pos_trans`` (2D x 2D) over the
selected proposals.  Its query_pos additions, norms, sine embedding and
top-k are not counted, as ``flops`` leaves out the elementwise work."""

from __future__ import annotations

from ..inputs import level_shapes
from .flops import _linear, detector_forward_flops


def two_stage_forward_flops(cfg: dict, B: int, hw) -> int:
    D, K, Q = cfg["emb_dim"], cfg["num_classes"], cfg["num_queries"]
    I = sum(h * w for h, w in level_shapes(cfg, hw))  # noqa: E741
    proposals = (_linear(B * I, D, D) + _linear(B * I, D, K)
                 + _linear(B * I, D, 4) + _linear(B * Q, 2 * D, 2 * D))
    return detector_forward_flops(cfg, B, hw) + proposals
