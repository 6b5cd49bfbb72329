"""Box geometry for detection matching and losses (PyTorch counterpart of
``msda_tpu/parallel/boxes.py``).

Generalized IoU (Rezatofighi et al. 2019, arXiv:1902.09630) is the third
term of the Deformable DETR matching cost and training loss
(arXiv:2010.04159 §4.1).  All functions take normalized ``(cx, cy, w, h)``
boxes, the format the model emits and the targets use, and are safe for
degenerate (zero-area) boxes: every ratio is eps-guarded, so that masked-out
or padded targets cannot inject NaNs that would survive a ``* mask``
(NaN * 0 is NaN).
"""

from __future__ import annotations

import torch

__all__ = [
    "box_cxcywh_to_xyxy",
    "box_iou_pairwise",
    "generalized_box_iou_pairwise",
    "generalized_box_iou",
]

_EPS = 1e-7


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] (cx, cy, w, h) -> (x0, y0, x1, y1)."""
    cx, cy, w, h = boxes.unbind(-1)
    half_w = 0.5 * w
    half_h = 0.5 * h
    return torch.stack(
        [cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1
    )


def _nonneg(x):
    # max(x, 0) as jnp.maximum differentiates it: a tie (a degenerate box)
    # passes half the gradient, where clamp would pass all of it
    return torch.maximum(x, torch.zeros_like(x))


def _area_xyxy(b):
    return _nonneg(b[..., 2] - b[..., 0]) * _nonneg(b[..., 3] - b[..., 1])


def _iou_union_xyxy(a, b):
    """IoU and union area of xyxy boxes, broadcasting over leading dims."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = _nonneg(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    union = _area_xyxy(a) + _area_xyxy(b) - inter
    return inter / (union + _EPS), union


def box_iou_pairwise(boxes_a, boxes_b):
    """Pairwise IoU of cxcywh boxes: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    a = box_cxcywh_to_xyxy(boxes_a)[..., :, None, :]
    b = box_cxcywh_to_xyxy(boxes_b)[..., None, :, :]
    iou, _ = _iou_union_xyxy(a, b)
    return iou


def _giou_xyxy(a, b):
    iou, union = _iou_union_xyxy(a, b)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = _nonneg(rb - lt)
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / (enclosing + _EPS)


def generalized_box_iou_pairwise(boxes_a, boxes_b):
    """Pairwise GIoU of cxcywh boxes: [..., N, 4] x [..., M, 4] -> [..., N, M].

    GIoU = IoU - (enclosing - union) / enclosing, in [-1, 1]; equals IoU
    when one box contains the other and decreases toward -1 as the boxes
    separate (arXiv:1902.09630 eq. 1-3).
    """
    a = box_cxcywh_to_xyxy(boxes_a)[..., :, None, :]
    b = box_cxcywh_to_xyxy(boxes_b)[..., None, :, :]
    return _giou_xyxy(a, b)


def generalized_box_iou(boxes_a, boxes_b):
    """Elementwise GIoU of matched cxcywh box pairs: [..., 4] x [..., 4] -> [...]."""
    return _giou_xyxy(box_cxcywh_to_xyxy(boxes_a),
                      box_cxcywh_to_xyxy(boxes_b))
