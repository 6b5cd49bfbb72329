"""DINO's training loss (the official ``SetCriterion`` with ``use_dn``) in
plain PyTorch: every decoder layer's matched loss, the interm outputs'
matched loss scaled by ``enc_weight``, and the denoising loss of every
layer's DN queries, which matches nothing.

The matched terms are ``reference.loss``'s (the auction on the host, focal
class loss over every query, 5 L1 + 2 GIoU on the matched boxes, each over
the number of real targets), with DINO's matching cost: its class term
weighted by ``class_cost`` (2).  The interm outputs keep the targets'
classes (DINO's encoder head has every class).  The denoising loss at each
layer: the query ``2 g m + r`` (group g, the batch's largest count of real
targets m) is the positive copy of the image's r-th real target and pays
the focal loss toward its class and L1 + GIoU toward its box; every other
DN query (the negative copies, the padding) pays the focal loss toward no
object; each term over the number of real targets times the groups."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .loss import _focal, auction, giou


def matching_cost(logits, boxes, labels, tboxes, loss_cfg):
    """``[B, N, M]``: ``class_cost`` times the focal class cost at each
    target's class, + 5 L1 - 2 GIoU."""
    alpha, gamma = loss_cfg["focal_alpha"], loss_cfg["focal_gamma"]
    p = torch.sigmoid(logits)
    neg = (1 - alpha) * p ** gamma * -torch.log1p(-p.clamp(0.0, 1.0 - 1e-8))
    pos = alpha * (1 - p) ** gamma * -torch.log(p.clamp(1e-8, 1.0))
    idx = labels[:, None, :].expand(-1, logits.shape[1], -1)
    cls = torch.gather(pos, 2, idx) - torch.gather(neg, 2, idx)
    l1 = (boxes[:, :, None, :] - tboxes[:, None, :, :]).abs().sum(-1)
    g = giou(boxes[:, :, None, :], tboxes[:, None, :, :])
    return (loss_cfg["class_cost"] * cls + loss_cfg["l1_weight"] * l1
            - loss_cfg["giou_weight"] * g)


def head_loss(out, targets, loss_cfg):
    """One matched head's loss (``reference.loss.head_loss`` with DINO's
    matching cost)."""
    logits, boxes = out["logits"], out["boxes"]
    labels, tboxes, mask = targets["labels"], targets["boxes"], targets["mask"]
    B, N, K = logits.shape
    with torch.no_grad():
        cost = matching_cost(logits, boxes, labels, tboxes, loss_cfg)
        cost = torch.where(mask[:, None, :] > 0, cost, torch.zeros_like(cost))
        q = auction(cost.float().cpu(), (mask > 0).cpu(),
                    loss_cfg["matcher_eps"],
                    loss_cfg["matcher_rounds"]).to(logits.device)
    n_real = mask.sum().clamp(min=1.0)
    safe_q = torch.where(mask > 0, q, torch.full_like(q, N))
    full = torch.full((B, N + 1), K, dtype=torch.int64, device=logits.device)
    full = full.scatter(1, safe_q, labels)[:, :N]
    onehot = F.one_hot(full, K + 1)[..., :K].to(logits.dtype)
    cls = _focal(logits, onehot, loss_cfg["focal_alpha"],
                 loss_cfg["focal_gamma"]).sum() / n_real
    sel = torch.gather(boxes, 1, q[..., None].expand(-1, -1, 4))
    l1 = ((sel - tboxes).abs().sum(-1) * mask).sum() / n_real
    g = ((1 - giou(sel, tboxes)) * mask).sum() / n_real
    return cls + loss_cfg["l1_weight"] * l1 + loss_cfg["giou_weight"] * g


def denoising_loss(dn, meta, targets, loss_cfg):
    """The DN queries' loss over every layer (the module docstring)."""
    m, groups = meta["max_targets"], meta["groups"]
    logits = dn["logits"]
    B, pad, K = logits.shape
    labels = torch.full((B, pad), K, dtype=torch.int64, device=logits.device)
    tboxes = torch.full((B, pad, 4), 0.5, device=logits.device)
    positive = torch.zeros((B, pad), device=logits.device)
    for b in range(B):
        real = [j for j, on in enumerate(targets["mask"][b].tolist()) if on]
        for g in range(groups):
            for r, j in enumerate(real):
                q = 2 * g * m + r
                labels[b, q] = targets["labels"][b, j]
                tboxes[b, q] = targets["boxes"][b, j]
                positive[b, q] = 1.0
    onehot = F.one_hot(labels, K + 1)[..., :K].to(logits.dtype)
    n = targets["mask"].sum().clamp(min=1.0) * groups
    total = 0.0
    for i, head in enumerate([dn, *dn["aux"]]):
        cls = _focal(head["logits"], onehot, loss_cfg["focal_alpha"],
                     loss_cfg["focal_gamma"]).sum() / n
        l1 = ((head["boxes"] - tboxes).abs().sum(-1) * positive).sum() / n
        g = ((1 - giou(head["boxes"], tboxes)) * positive).sum() / n
        term = cls + loss_cfg["l1_weight"] * l1 + loss_cfg["giou_weight"] * g
        total = total + (term if i == 0 else loss_cfg["aux_weight"] * term)
    return total


def detection_loss(out, targets, loss_cfg):
    """The whole loss of one step's outputs (``reference.detr_dino``)."""
    loss = head_loss(out, targets, loss_cfg)
    for aux in out["aux"]:
        loss = loss + loss_cfg["aux_weight"] * head_loss(aux, targets,
                                                         loss_cfg)
    loss = loss + loss_cfg["enc_weight"] * head_loss(out["interm"], targets,
                                                     loss_cfg)
    if "dn" in out:
        loss = loss + denoising_loss(out["dn"], out["dn_meta"], targets,
                                     loss_cfg)
    return loss
