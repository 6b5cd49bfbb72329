"""Detection loss and train step (PyTorch counterpart of
``msda_tpu/parallel/train.py``), single device.

``detection_loss`` is the published Deformable DETR recipe: every decoder
layer's prediction pays a classification loss (softmax CE with background,
or sigmoid focal) plus 5 * L1 + 2 * GIoU on its matched boxes, with the
auction matcher or a fixed teacher-forced matching, and the two-stage
encoder proposals pay their own objectness + box loss.  ``make_train_step``
builds the eager step: forward, loss, backward, optimizer step.

The JAX function's ``mesh`` argument, ``replicate_params`` and
``shard_params`` are the multi-device form and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profile import annotate
from .boxes import generalized_box_iou
from .matcher import auction_assignment, matching_cost

__all__ = ["detection_loss", "make_train_step"]


def detection_loss(outputs, targets, matcher: str = "fixed",
                   aux_weight: float = 1.0, enc_weight: float = 1.0,
                   giou_weight: float = 2.0, class_loss: str = "ce",
                   eos_coef: float = 0.1, l1_weight: float = 5.0,
                   matcher_rounds: int = 2000,
                   return_metrics: bool = False):
    """Detection loss (classification + 5 * L1 box + 2 * GIoU, the
    published Deformable DETR weights, arXiv:2010.04159 §4.1; GIoU per
    arXiv:1902.09630).  ``giou_weight=0`` disables the GIoU term
    everywhere, including the encoder proposal loss.

    targets: dict(labels=[B, M] int, boxes=[B, M, 4] cxcywh in [0, 1],
    mask=[B, M] 1.0 for real objects).

    Every query receives classification supervision: matched queries pay
    for their target class, all others for "no object".

    class_loss:
        "ce":    softmax cross-entropy with the LAST class as no-object
                 background, down-weighted by ``eos_coef`` (pair with
                 ``postprocess(scoring="softmax")``).
        "focal": sigmoid focal loss (alpha=0.25, gamma=2) with no
                 background class: unmatched queries get all-zero targets
                 (pair with ``postprocess(scoring="sigmoid")``).

    matcher:
        "fixed":   queries matched to targets by index (teacher-forced).
        "auction": minimum-cost bipartite matching by the auction solver
                   (``parallel.matcher``), the DETR recipe.

    ``outputs["aux"]`` (per-decoder-layer predictions of
    ``DeformableDetr(with_box_refinement=True)``) pay the same loss scaled
    by ``aux_weight``; ``outputs["enc"]`` (two-stage proposals) pay
    :func:`_enc_proposal_loss` scaled by ``enc_weight``.

    With ``return_metrics=True`` the call returns ``(loss, metrics)``, where
    ``metrics["matcher_converged"]`` is a bool tensor on the loss's device:
    False means some auction matching hit its ``matcher_rounds`` budget and
    fell back to per-target argmin.  It is not read back to the host here.
    """
    loss, converged = _single_detection_loss(
        outputs, targets, matcher, giou_weight, class_loss, eos_coef,
        l1_weight=l1_weight, matcher_rounds=matcher_rounds)
    for aux_out in outputs.get("aux", ()):
        aux_loss, aux_conv = _single_detection_loss(
            aux_out, targets, matcher, giou_weight, class_loss, eos_coef,
            l1_weight=l1_weight, matcher_rounds=matcher_rounds)
        loss = loss + aux_weight * aux_loss
        converged = converged & aux_conv
    if "enc" in outputs:
        loss = loss + enc_weight * _enc_proposal_loss(
            outputs["enc"], targets, giou_weight=giou_weight,
            l1_weight=l1_weight)
    if return_metrics:
        return loss, {"matcher_converged": converged}
    return loss


def _sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def _sigmoid_focal(logits, labels, alpha, gamma):
    """optax.sigmoid_focal_loss for {0, 1} labels: the BCE scaled by
    (1 - p_t) ** gamma, taken in log space, and by alpha_t."""
    log_one_minus_pt = torch.where(labels > 0, F.logsigmoid(-logits),
                                   F.logsigmoid(logits))
    loss = _sigmoid_bce(logits, labels) * torch.exp(gamma * log_one_minus_pt)
    return (alpha * labels + (1.0 - alpha) * (1.0 - labels)) * loss


def _enc_proposal_loss(enc, targets, giou_weight=2.0, l1_weight=5.0):
    """Two-stage encoder proposal loss (the JAX package's static-shape form
    of arXiv:2010.04159 §A.4).

    Each real target is assigned the proposal whose *anchor* center is
    nearest its box center.  Assigned proposals pay binary objectness + L1
    + GIoU box losses; every other pixel pays background objectness, the
    positive and negative halves normalized separately.
    """
    obj = enc["logits"][..., 0]  # [B, I]
    pboxes = enc["boxes"]        # [B, I, 4]
    anchors = enc["anchors"]     # [I, 4] normalized cxcywh
    tboxes = targets["boxes"]    # [B, M, 4]
    mask = targets["mask"].to(obj.dtype)  # [B, M]

    # nearest-anchor-center assignment per target: [B, M]
    d = (anchors[None, :, None, :2] - tboxes[:, None, :, :2]).abs().sum(-1)
    idx = d.argmin(1)

    pos = torch.zeros_like(obj).scatter_add(1, idx, mask).clamp(0.0, 1.0)
    bce = _sigmoid_bce(obj, pos)
    n_pos = pos.sum().clamp(min=1.0)
    n_neg = (1.0 - pos).sum().clamp(min=1.0)
    obj_loss = (bce * pos).sum() / n_pos + (bce * (1.0 - pos)).sum() / n_neg

    sel = torch.gather(pboxes, 1, idx[..., None].expand(-1, -1, 4))
    l1 = (sel - tboxes).abs().sum(-1)
    n_real = mask.sum().clamp(min=1.0)
    loss = obj_loss + l1_weight * (l1 * mask).sum() / n_real
    if giou_weight:
        giou = generalized_box_iou(sel, tboxes)
        loss = loss + giou_weight * ((1.0 - giou) * mask).sum() / n_real
    return loss


def _single_detection_loss(outputs, targets, matcher, giou_weight=2.0,
                           class_loss="ce", eos_coef=0.1,
                           focal_alpha=0.25, focal_gamma=2.0,
                           l1_weight=5.0, matcher_rounds=2000):
    """Loss for one prediction head.  Returns ``(loss, converged)``, where
    ``converged`` is a bool tensor: True unless the auction matcher failed
    to assign every active target within ``matcher_rounds`` for some batch
    element (the fixed matcher is always True)."""
    logits = outputs["logits"]  # [B, N, K]
    boxes = outputs["boxes"]    # [B, N, 4]
    labels = targets["labels"].to(torch.int64)  # [B, M]
    tboxes = targets["boxes"]   # [B, M, 4]
    mask = targets["mask"].to(logits.dtype)  # [B, M]
    B, N, K = logits.shape
    M = labels.shape[1]
    if M > N:
        raise ValueError(
            f"more targets ({M}) than queries ({N}): every real target "
            "needs a distinct query"
        )
    device = logits.device

    if matcher == "auction":
        # the matcher's class cost follows the training objective
        cost_kind = "focal" if class_loss == "focal" else "softmax"
        with torch.no_grad():
            cost = matching_cost(logits, boxes, labels, tboxes,
                                 class_cost=cost_kind)  # [B, N, M]
            # masked-out targets must not steal queries: make them cheap
            # everywhere equally (constant column -> arbitrary but harmless)
            cost = torch.where(mask[:, None, :] > 0, cost,
                               torch.zeros_like(cost))
            q_idx, conv = auction_assignment(
                cost, mask, max_rounds=matcher_rounds, return_state=True)
        converged = conv.all()
    elif matcher == "fixed":
        q_idx = torch.arange(M, device=device).expand(B, M)
        converged = torch.ones((), dtype=torch.bool, device=device)
    else:
        raise ValueError(f"matcher must be 'fixed' or 'auction', got {matcher!r}")

    sel_boxes = torch.gather(boxes, 1, q_idx[..., None].expand(-1, -1, 4))

    # Per-query class assignment covering EVERY query: matched queries get
    # their target class, all others the no-object value: the last class
    # for "ce", the out-of-range index K for "focal" (an all-zero target
    # row).  Masked-out targets scatter into a dummy column N, so that they
    # can never overwrite a real match.
    no_object = K - 1 if class_loss == "ce" else K
    safe_q = torch.where(mask > 0, q_idx, torch.full_like(q_idx, N))
    full_labels = torch.full((B, N + 1), no_object, dtype=torch.int64,
                             device=device).scatter(1, safe_q, labels)[:, :N]

    n_real = mask.sum().clamp(min=1.0)
    if class_loss == "ce":
        ce = F.cross_entropy(logits.reshape(B * N, K),
                             full_labels.reshape(B * N),
                             reduction="none").reshape(B, N)
        w = torch.where(full_labels == no_object, eos_coef, 1.0).to(ce.dtype)
        cls = (ce * w).sum() / w.sum()
    elif class_loss == "focal":
        # K + 1 classes, the last one dropped: no-object -> all-zero row
        onehot = F.one_hot(full_labels, K + 1)[..., :K].to(logits.dtype)
        focal = _sigmoid_focal(logits, onehot, focal_alpha, focal_gamma)
        # Deformable DETR normalization: SUM over classes (not mean),
        # divided by the number of real boxes
        cls = focal.sum() / n_real
    else:
        raise ValueError(
            f"class_loss must be 'ce' or 'focal', got {class_loss!r}")

    # box-term weights match the matching cost's (the paper uses the same
    # 5 * L1 + 2 * GIoU in cost and loss)
    l1 = (sel_boxes - tboxes).abs().sum(-1)
    loss = cls + l1_weight * (l1 * mask).sum() / n_real
    if giou_weight:
        giou = generalized_box_iou(sel_boxes, tboxes)  # [B, M]
        loss = loss + giou_weight * ((1.0 - giou) * mask).sum() / n_real
    return loss, converged


def make_train_step(model, optimizer, img_shapes, matcher: str = "fixed",
                    aux_weight: float = 1.0, enc_weight: float = 1.0,
                    giou_weight: float = 2.0, class_loss: str = "ce",
                    eos_coef: float = 0.1, l1_weight: float = 5.0,
                    matcher_rounds: int = 2000,
                    return_metrics: bool = False):
    """Build a train step ``step(pyramid, targets) -> loss`` for ``model``
    (an ``nn.Module`` returning the outputs :func:`detection_loss` takes)
    and a ``torch.optim`` ``optimizer`` over its parameters.

    The step zeroes the gradients, runs the forward, the loss and the
    backward, and steps the optimizer; the last three in the profiler spans
    (``utils.profile.annotate``) "loss", "backward" and "optimizer".  Every
    :func:`detection_loss` knob is threaded through.  ``torch.optim.AdamW(params, lr,
    weight_decay=1e-4)`` is the counterpart of the JAX demo's
    ``optax.adamw(lr)``: pass ``weight_decay`` explicitly, since optax's
    default is 1e-4 and torch's 1e-2.

    ``return_metrics=True`` makes the step return ``(loss, metrics)`` with
    ``metrics["matcher_converged"]``, a device tensor: nothing syncs with
    the host per step unless the caller reads it.  The returned loss is
    detached.
    """
    loss_kw = dict(matcher=matcher, aux_weight=aux_weight,
                   enc_weight=enc_weight, giou_weight=giou_weight,
                   class_loss=class_loss, eos_coef=eos_coef,
                   l1_weight=l1_weight, matcher_rounds=matcher_rounds,
                   return_metrics=True)

    def step(pyramid, targets):
        optimizer.zero_grad(set_to_none=True)
        outputs = model(pyramid, img_shapes)
        with annotate("loss"):
            loss, metrics = detection_loss(outputs, targets, **loss_kw)
        with annotate("backward"):
            loss.backward()
        with annotate("optimizer"):
            optimizer.step()
        if return_metrics:
            return loss.detach(), metrics
        return loss.detach()

    return step
