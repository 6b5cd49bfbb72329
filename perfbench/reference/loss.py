"""The detection loss of Deformable DETR in plain PyTorch: the matching
cost (focal class cost + 5 L1 + 2 GIoU), the auction matcher as a plain
loop on the host, and the loss (sigmoid focal + 5 L1 + 2 GIoU on the
matched boxes, the same for every auxiliary head), arXiv:2010.04159 §4.1
with the departures of ``configs/ddetr-refine.json``.  Boxes are
normalized cxcywh."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-7
_NEG = -1e30


def xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _relu0(x):
    # max(x, 0) with half the gradient at a tie, as the program's
    return torch.maximum(x, torch.zeros_like(x))


def giou(a, b):
    """GIoU of cxcywh boxes, broadcasting (arXiv:1902.09630)."""
    a, b = xyxy(a), xyxy(b)

    def area(t):
        return _relu0(t[..., 2] - t[..., 0]) * _relu0(t[..., 3] - t[..., 1])

    wh = _relu0(torch.minimum(a[..., 2:], b[..., 2:])
                - torch.maximum(a[..., :2], b[..., :2]))
    inter = wh[..., 0] * wh[..., 1]
    union = area(a) + area(b) - inter
    iou = inter / (union + _EPS)
    wh = _relu0(torch.maximum(a[..., 2:], b[..., 2:])
                - torch.minimum(a[..., :2], b[..., :2]))
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / (enclosing + _EPS)


def matching_cost(logits, boxes, labels, tboxes, loss_cfg):
    """``[B, N, M]``: the focal class cost at each target's class (alpha
    0.25, gamma 2) + 5 L1 - 2 GIoU."""
    alpha, gamma = loss_cfg["focal_alpha"], loss_cfg["focal_gamma"]
    p = torch.sigmoid(logits)
    neg = (1 - alpha) * p ** gamma * -torch.log1p(-p.clamp(0.0, 1.0 - 1e-8))
    pos = alpha * (1 - p) ** gamma * -torch.log(p.clamp(1e-8, 1.0))
    idx = labels[:, None, :].expand(-1, logits.shape[1], -1)
    cls = torch.gather(pos, 2, idx) - torch.gather(neg, 2, idx)
    l1 = (boxes[:, :, None, :] - tboxes[:, None, :, :]).abs().sum(-1)
    g = giou(boxes[:, :, None, :], tboxes[:, None, :, :])
    return cls + loss_cfg["l1_weight"] * l1 - loss_cfg["giou_weight"] * g


def auction(cost, active, eps, max_rounds):
    """Min-cost assignment of targets to queries by the auction algorithm
    (Bertsekas 1988), single phase, synchronous rounds, the lowest index
    on ties: ``cost`` ``[B, N, M]``, ``active`` ``[B, M]`` bool.  Returns
    the query of each target ``[B, M]``; a target that won none by
    ``max_rounds`` takes its cheapest query."""
    B, N, M = cost.shape
    profit = -cost.transpose(1, 2)  # [B, M, N]
    owner = torch.full((B, N), -1, dtype=torch.int64)
    price = torch.zeros((B, N), dtype=cost.dtype)
    targets = torch.arange(M)
    eps = torch.tensor(eps, dtype=cost.dtype)
    for _ in range(max_rounds):
        owns = owner[:, None, :] == targets[None, :, None]  # [B, M, N]
        bidder = active & ~owns.any(-1)
        if not bidder.any():
            break
        values = profit - price[:, None, :]
        best, best_q = values.amax(-1), values.argmax(-1)
        second = values.scatter(-1, best_q[..., None], _NEG).amax(-1)
        bid = best - second + eps
        wants = bidder[..., None] & (torch.arange(N) == best_q[..., None])
        bids = torch.where(wants, bid[..., None],
                           torch.full_like(values, _NEG))
        top, top_bidder = bids.amax(1), bids.argmax(1)
        won = top > _NEG / 2
        price = torch.where(won, price + top, price)
        owner = torch.where(won, top_bidder, owner)
    owns = owner[:, None, :] == targets[None, :, None]
    return torch.where(owns.any(-1), owns.to(torch.uint8).argmax(-1),
                       cost.argmin(1))


def _focal(logits, onehot, alpha, gamma):
    bce = -onehot * F.logsigmoid(logits) - (1 - onehot) * F.logsigmoid(-logits)
    log_1m_pt = torch.where(onehot > 0, F.logsigmoid(-logits),
                            F.logsigmoid(logits))
    return ((alpha * onehot + (1 - alpha) * (1 - onehot)) * bce
            * torch.exp(gamma * log_1m_pt))


def head_loss(out, targets, loss_cfg):
    """One head's loss: matched by the auction on the host, focal class
    loss over every query (unmatched ones all-negative), summed over
    classes, plus 5 L1 + 2 (1 - GIoU) on the matched boxes, each over the
    number of real targets."""
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


def detection_loss(out, targets, loss_cfg):
    """The final head's loss plus ``aux_weight`` times each auxiliary
    head's."""
    loss = head_loss(out, targets, loss_cfg)
    for aux in out.get("aux", ()):
        loss = loss + loss_cfg["aux_weight"] * head_loss(aux, targets,
                                                         loss_cfg)
    return loss
