"""The published two-stage Deformable DETR loss in plain PyTorch: the
decoder's heads as ``reference.loss`` takes them, plus ``enc_weight`` times
the proposal term of the official ``SetCriterion`` (its ``enc_outputs``):
every target's label set to class 0, matched by the auction on the host
over all I proposals, and the decoder's head loss on them (focal over all
I x K logits, 5 L1 + 2 GIoU on the matched proposals)."""

from __future__ import annotations

import torch

from .loss import detection_loss as decoder_loss
from .loss import head_loss


def proposal_loss(enc, targets, loss_cfg):
    binary = dict(targets, labels=torch.zeros_like(targets["labels"]))
    return head_loss({"logits": enc["logits"], "boxes": enc["boxes"]},
                     binary, loss_cfg)


def detection_loss(out, targets, loss_cfg):
    return (decoder_loss(out, targets, loss_cfg)
            + loss_cfg["enc_weight"] * proposal_loss(out["enc"], targets,
                                                     loss_cfg))
