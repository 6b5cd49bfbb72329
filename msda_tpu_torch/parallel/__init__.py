"""Training recipe: box geometry, the auction matcher, the detection loss,
the train step and checkpoints (single device).  The multi-device mesh of
``msda_tpu.parallel`` is not ported yet."""

from .boxes import (
    box_cxcywh_to_xyxy,
    box_iou_pairwise,
    generalized_box_iou,
    generalized_box_iou_pairwise,
)
from .checkpoint import TrainCheckpointer
from .matcher import auction_assignment, matching_cost
from .train import detection_loss, make_train_step

__all__ = [
    "box_cxcywh_to_xyxy",
    "box_iou_pairwise",
    "generalized_box_iou",
    "generalized_box_iou_pairwise",
    "auction_assignment",
    "matching_cost",
    "detection_loss",
    "make_train_step",
    "TrainCheckpointer",
]
