"""Box geometry (PyTorch counterpart of ``msda_tpu/parallel/boxes.py``).

Only what serving needs is ported so far: ``box_cxcywh_to_xyxy``, used by
``models.detr.postprocess``.  The IoU / GIoU helpers go with training.
"""

from __future__ import annotations

import torch

__all__ = ["box_cxcywh_to_xyxy"]


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] (cx, cy, w, h) -> (x0, y0, x1, y1)."""
    cx, cy, w, h = boxes.unbind(-1)
    half_w = 0.5 * w
    half_h = 0.5 * h
    return torch.stack(
        [cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1
    )
