"""Bipartite matching for detection training (PyTorch counterpart of
``msda_tpu/parallel/matcher.py``).

Deformable DETR (arXiv:2010.04159 §4.1, following DETR) matches queries to
ground-truth boxes with a minimum-cost bipartite assignment before computing
the loss.  This is the JAX package's **auction algorithm** (Bertsekas 1988),
single phase, with the same bid increment, round budget, argmin fallback
and tie-breaking, so that both packages give the same assignment, index for
index, on the same cost matrix.

The JAX solver runs per image under ``jax.vmap``; here the batch is an
explicit leading axis.  Under ``vmap`` every element steps until the last
one has converged, and a round taken after an element has converged changes
nothing for it (no target bids, so no query is won), so the batched loop
equals the vmapped one.  On the card, testing convergence costs a
device-to-host sync, so rounds run in chunks (``_CHUNK``) and convergence is
tested once per chunk; the loop still stops at exactly ``max_rounds``.
"""

from __future__ import annotations

import torch

__all__ = ["auction_assignment", "matching_cost"]

_NEG = -1e30
_CHUNK = 16  # rounds between convergence tests


def _auction_round(profit, active, eps, owner, price):
    """One synchronous bidding round for every batch element.

    profit [B, M, N]: targets bid for queries; active [B, M] bool;
    owner [B, N] int64 (-1 = free); price [B, N].  Returns (owner, price).
    """
    B, M, N = profit.shape
    targets = torch.arange(M, device=profit.device)
    assigned = (owner[:, None, :] == targets[None, :, None]).any(-1)
    bidder = active & ~assigned  # [B, M]: targets bidding this round

    values = profit - price[:, None, :]  # [B, M, N]
    best = values.amax(-1)
    best_q = values.argmax(-1)  # the first index on ties, as jnp.argmax
    masked = values.scatter(-1, best_q[..., None], _NEG)
    second = masked.amax(-1)
    bid = best - second + eps  # [B, M]

    # each query takes the highest bid among the bidders targeting it
    wants = bidder[..., None] & (
        torch.arange(N, device=profit.device) == best_q[..., None])
    bid_matrix = torch.where(wants, bid[..., None],
                             torch.full_like(values, _NEG))  # [B, M, N]
    top_bid = bid_matrix.amax(1)  # [B, N]
    top_bidder = bid_matrix.argmax(1)
    won = top_bid > _NEG / 2
    price = torch.where(won, price + top_bid, price)
    owner = torch.where(won, top_bidder, owner)  # unseats the previous owner
    return owner, price


def auction_assignment(cost, target_mask=None, eps=1e-3, max_rounds=2000,
                       return_state=False):
    """Min-cost assignment of targets to queries via the auction algorithm,
    single phase (see the JAX function's design note for why there is no
    epsilon scaling).

    Args:
        cost: ``[N, M]`` or batched ``[B, N, M]`` float cost of assigning
            query n to target m (N >= M).
        target_mask: optional ``[M]`` / ``[B, M]`` {0, 1}; masked-out targets
            are not assigned (their returned index is valid but
            meaningless).
        eps: bid increment; suboptimality is bounded by ``M * eps``.
        max_rounds: the number of bidding rounds at most.
        return_state: also return ``converged``, a bool tensor (per batch
            element for a batched cost): False means some active target
            never won a query within the round budget and its index fell
            back to ``argmin`` (possibly a duplicate).

    Returns:
        ``query_idx`` ``[M]`` / ``[B, M]`` int64: the query assigned to each
        target (and ``converged`` if ``return_state``).  Nothing is read back
        to the host except one convergence flag per chunk of rounds.
    """
    batched = cost.ndim == 3
    if not batched:
        cost = cost[None]
        if target_mask is not None:
            target_mask = target_mask[None]
    cost = cost.detach().to(torch.float32)
    B, N, M = cost.shape
    profit = -cost.transpose(1, 2)  # [B, M, N]
    if target_mask is not None:
        active = target_mask.to(torch.bool)
    else:
        active = torch.ones((B, M), dtype=torch.bool, device=cost.device)
    eps = torch.tensor(eps, dtype=torch.float32, device=cost.device)
    targets = torch.arange(M, device=cost.device)

    owner = torch.full((B, N), -1, dtype=torch.int64, device=cost.device)
    price = torch.zeros((B, N), dtype=torch.float32, device=cost.device)
    rounds = 0
    while rounds < max_rounds:
        for _ in range(min(_CHUNK, max_rounds - rounds)):
            owner, price = _auction_round(profit, active, eps, owner, price)
        rounds += min(_CHUNK, max_rounds - rounds)
        assigned = (owner[:, None, :] == targets[None, :, None]).any(-1)
        if not (active & ~assigned).any():
            break

    # per-target assigned query: the query it owns (argmin-cost fallback
    # only for non-termination, surfaced via ``converged``)
    owns = owner[:, None, :] == targets[None, :, None]  # [B, M, N]
    q_idx = owns.to(torch.uint8).argmax(-1)  # first owned query
    any_own = owns.any(-1)
    fallback = cost.argmin(1)  # [B, M]
    out = torch.where(any_own, q_idx, fallback)
    converged = (~active | any_own).all(-1)
    if not batched:
        out, converged = out[0], converged[0]
    if return_state:
        return out, converged
    return out


def matching_cost(logits, boxes, labels, tboxes, class_weight=1.0,
                  box_weight=5.0, giou_weight=2.0, class_cost="softmax"):
    """DETR-style matching cost matrix ``[..., N_queries, M_targets]``:
    ``class + 5 * L1(box) - 2 * GIoU(box)``, the Deformable DETR matching
    recipe with its published weights (arXiv:2010.04159 §4.1; GIoU per
    arXiv:1902.09630).  Leading batch dimensions are allowed.

    class_cost:
        "softmax": ``-softmax(logits)[class]``, DETR's cost; pairs with the
            CE-with-background training loss.
        "focal": the alpha-balanced modulated sigmoid cost (pos_cost -
            neg_cost at the target class, alpha=0.25, gamma=2) of the
            Deformable DETR matcher; pairs with
            ``detection_loss(class_loss="focal")``.
    """
    from .boxes import generalized_box_iou_pairwise

    if class_cost == "softmax":
        prob = torch.softmax(logits, dim=-1)  # [..., N, K]
        cls_cost = -_take_classes(prob, labels)
    elif class_cost == "focal":
        alpha, gamma = 0.25, 2.0
        prob = torch.sigmoid(logits)
        neg = (1.0 - alpha) * prob**gamma * (
            -torch.log1p(-prob.clamp(0.0, 1.0 - 1e-8)))
        pos = alpha * (1.0 - prob) ** gamma * (
            -torch.log(prob.clamp(1e-8, 1.0)))
        cls_cost = _take_classes(pos, labels) - _take_classes(neg, labels)
    else:
        raise ValueError(
            f"class_cost must be 'softmax' or 'focal', got {class_cost!r}")
    l1 = (boxes[..., :, None, :] - tboxes[..., None, :, :]).abs().sum(-1)
    cost = class_weight * cls_cost + box_weight * l1
    if giou_weight:
        cost = cost - giou_weight * generalized_box_iou_pairwise(boxes, tboxes)
    return cost


def _take_classes(per_class, labels):
    """``per_class[..., n, labels[..., m]]`` -> ``[..., N, M]``."""
    idx = labels.to(torch.int64)[..., None, :].expand(
        *per_class.shape[:-1], labels.shape[-1])
    return torch.gather(per_class, -1, idx)
