"""Training recipe and multi-device execution: the device mesh and the
op's placements on it, box geometry, the auction matcher, the detection
loss, the train step (on one device or a mesh) and checkpoints."""

from .sharding import (
    MSDA_SHARDINGS,
    make_mesh,
    shard_map_multiscale_deformable_attention,
    shard_msda_args,
    sharded_multiscale_deformable_attention,
)
from .boxes import (
    box_cxcywh_to_xyxy,
    box_iou_pairwise,
    generalized_box_iou,
    generalized_box_iou_pairwise,
)
from .checkpoint import TrainCheckpointer
from .matcher import auction_assignment, matching_cost
from .train import (detection_loss, make_train_step, replicate_params,
                    shard_params)

__all__ = [
    "make_mesh",
    "MSDA_SHARDINGS",
    "shard_msda_args",
    "sharded_multiscale_deformable_attention",
    "shard_map_multiscale_deformable_attention",
    "detection_loss",
    "make_train_step",
    "replicate_params",
    "shard_params",
    "auction_assignment",
    "matching_cost",
    "box_cxcywh_to_xyxy",
    "box_iou_pairwise",
    "generalized_box_iou",
    "generalized_box_iou_pairwise",
    "TrainCheckpointer",
]
