"""DINO's contrastive denoising (CDN) queries (arXiv:2203.03605 §3.3; the
official ``models/dino/dn_components.py``, ``prepare_for_cdn``), built on
the device with no host sync, so that a train step that builds them can be
captured as a CUDA graph.

The caller gives ``max_targets``, the batch's largest count of real
targets, as a host int (DINO reads it back from the device with
``.item()``; here the caller knows it when it builds the batch).  With
``DN_NUMBER`` it fixes the shape: ``groups = 2 * DN_NUMBER // (2 *
max_targets)`` (DINO's rule, :func:`cdn_shape`) and ``pad = 2 * groups *
max_targets`` DN queries an image.  Group g holds
two copies of the image's real targets, in their slot order: the positive
copy at queries ``[2 g m, 2 g m + m)`` and the negative one at ``[2 g m + m,
2 (g + 1) m)``, m = ``max_targets``; an image with fewer than m real
targets leaves the rest of each copy as padding (a zero label embedding and
box logits 0).

Noise, from the step's own draws (:func:`draw`, on the device's default
generator, which a CUDA graph replays with a new offset each time):

- labels: each copy's label flipped to a uniform class where a uniform
  draw falls below ``LABEL_NOISE_RATIO / 2``, then embedded by the
  model's ``label_enc`` table;
- boxes: each corner of the (x0, y0, x1, y1) box moved by ``u * sign *
  (w / 2, h / 2) * BOX_NOISE_SCALE``, u uniform in [0, 1) for positives and
  [1, 2) for negatives, the sign uniform in {-1, 1}, then clamped to [0, 1];
  the box's logits are the decoder's first reference (DINO's
  ``inverse_sigmoid``, clamped at 1e-3).

The group attention mask (:func:`attention_mask`) lets no matching query
see a DN query, and no DN query see another group's; a DN query sees its
own group and every matching query, as in DINO.

``BUILT`` counts the DN queries the train steps built, ``batch * pad`` a
step: ``parallel.train.make_train_step``'s step adds them on the host at
each call, since a graphed step's replay runs none of this module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["BOX_NOISE_SCALE", "BUILT", "DN_NUMBER", "LABEL_NOISE_RATIO",
           "attention_mask", "build", "cdn_shape", "draw", "dn_targets",
           "sorted_targets"]

# DINO's published settings (config/DINO/DINO_5scale.py: dn_number,
# dn_label_noise_ratio, dn_box_noise_scale)
DN_NUMBER = 100
LABEL_NOISE_RATIO = 0.5
BOX_NOISE_SCALE = 1.0
# DN queries the train steps built since import (or since a caller reset it)
BUILT = 0


def cdn_shape(max_targets: int) -> tuple[int, int]:
    """``(groups, pad)`` of a batch whose largest count of real targets is
    ``max_targets``: DINO's ``prepare_for_cdn`` rule, (0, 0) without a
    target."""
    m = int(max_targets)
    if m <= 0:
        return 0, 0
    # DINO divides by 2 m from 100 copies on, which DN_NUMBER >= 50 makes
    groups = max(2 * DN_NUMBER // (2 * m), 1)
    return groups, 2 * groups * m


def sorted_targets(targets: dict, m: int):
    """Each image's real targets first, in their slot order, cut to ``m``:
    ``(labels [B, m] int64, boxes [B, m, 4], present [B, m] bool)``, zeros
    where ``present`` is False.  A cumulative sum ranks the real slots, so
    nothing is read back to the host."""
    mask = targets["mask"] > 0
    B = mask.shape[0]
    rank = mask.long().cumsum(1) - 1
    slot = torch.where(mask & (rank < m), rank, torch.full_like(rank, m))
    labels = torch.zeros((B, m + 1), dtype=torch.int64, device=mask.device)
    labels = labels.scatter(1, slot, targets["labels"].long())[:, :m]
    boxes = torch.zeros((B, m + 1, 4), dtype=targets["boxes"].dtype,
                        device=mask.device)
    boxes = boxes.scatter(1, slot[..., None].expand(-1, -1, 4),
                          targets["boxes"])[:, :m]
    count = mask.sum(1, keepdim=True)
    present = torch.arange(m, device=mask.device)[None] < count
    return labels, boxes, present


def draw(batch: int, groups: int, m: int, num_classes: int,
         device) -> dict:
    """A build's random draws on ``device``'s default generator, ``[B,
    2 groups, m]`` a query copy: ``flip`` and ``part`` uniform in [0, 1)
    (``part`` by box corner, ``[..., 4]``), ``label`` a uniform class and
    ``sign`` uniform in {-1, 1} (f32, by corner)."""
    shape = (batch, 2 * groups, m)
    return {"flip": torch.rand(shape, device=device),
            "label": torch.randint(0, num_classes, shape, device=device),
            "sign": torch.randint(0, 2, (*shape, 4), device=device).float()
            * 2.0 - 1.0,
            "part": torch.rand((*shape, 4), device=device)}


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """DINO's ``inverse_sigmoid``: ``x`` clamped to [0, 1], then
    ``log(max(x, eps) / max(1 - x, eps))``."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def build(label_enc: torch.Tensor, targets: dict, m: int, groups: int,
          draws: dict):
    """The DN queries of a batch from its targets and a build's ``draws``:
    ``(queries [B, pad, D], box logits [B, pad, 4])`` (the module
    docstring), ``label_enc`` the ``[classes + 1, D]`` label table."""
    labels, boxes, present = sorted_targets(targets, m)
    B, copies = labels.shape[0], 2 * groups
    pad = copies * m
    labels = torch.where(draws["flip"] < LABEL_NOISE_RATIO * 0.5,
                         draws["label"], labels[:, None].expand(-1, copies,
                                                                -1))
    boxes = boxes[:, None].expand(-1, copies, -1, -1)
    half = boxes[..., 2:] / 2
    xyxy = torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], -1)
    diff = torch.cat([half, half], -1)
    negative = (torch.arange(copies, device=boxes.device) % 2).to(
        boxes.dtype)[None, :, None, None]
    part = (draws["part"] + negative) * draws["sign"]
    xyxy = (xyxy + part * diff * BOX_NOISE_SCALE).clamp(0.0, 1.0)
    boxes = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2,
                       xyxy[..., 2:] - xyxy[..., :2]], -1)
    keep = present[:, None, :, None]
    queries = torch.where(keep, F.embedding(labels, label_enc), 0.0)
    unact = torch.where(keep, _inverse_sigmoid(boxes), 0.0)
    return (queries.reshape(B, pad, -1),
            unact.reshape(B, pad, 4).to(label_enc.dtype))


def attention_mask(m: int, groups: int, num_queries: int,
                   device=None) -> torch.Tensor:
    """``[pad + Q, pad + Q]`` bool, True where a query (row) may not see a
    key (column): a DN key of another group than the query's, matching
    queries counting as a group of their own."""
    pad = 2 * groups * m
    idx = torch.arange(pad + num_queries, device=device)
    group = torch.where(idx < pad, idx // max(2 * m, 1),
                        torch.full_like(idx, -1))
    return (idx < pad)[None, :] & (group[:, None] != group[None, :])


def dn_targets(targets: dict, m: int, groups: int, num_classes: int):
    """What each DN query is trained toward: ``(labels [B, pad], boxes [B,
    pad, 4], positive [B, pad] bool)``; a positive copy of a real target
    takes its label and box, and every other query (a negative, padding)
    the no-object label ``num_classes``."""
    labels, boxes, present = sorted_targets(targets, m)
    B, copies = labels.shape[0], 2 * groups
    even = torch.arange(copies, device=labels.device) % 2 == 0
    positive = present[:, None, :] & even[None, :, None]
    labels = torch.where(positive, labels[:, None],
                         torch.full_like(labels[:, None], num_classes))
    boxes = boxes[:, None].expand(-1, copies, -1, -1)
    return (labels.reshape(B, -1), boxes.reshape(B, -1, 4),
            positive.reshape(B, -1))
