"""Detection loss and train step (PyTorch counterpart of
``msda_tpu/parallel/train.py``), on one device or a device mesh.

``detection_loss`` is the published Deformable DETR recipe: every decoder
layer's prediction pays a classification loss (softmax CE with background,
or sigmoid focal) plus 5 * L1 + 2 * GIoU on its matched boxes, with the
auction matcher or a fixed teacher-forced matching, and the two-stage
encoder proposals pay their own loss: objectness + box in the JAX
package's static-shape form, and in the published form
(``DeformableDetr(two_stage="published")``) the decoder's loss over every
encoder token with every target's class set to 0; the DINO form
(``DeformableDetr(two_stage="dino")``) adds the loss of its selected
proposals (``interm``) and of its denoising queries (``dn``).
``make_train_step``
builds the step: forward, loss, backward, optimizer step.  On a card
without a mesh the step is captured once as a CUDA graph and replayed, the
counterpart of the JAX step's ``jax.jit``: one program a step, with no host
round trip (the auction matcher is one kernel, ``matcher``).

On a mesh (``make_train_step(mesh=...)``), one step equals one step of the
unsharded model over the global batch.  Each rank takes its dp block of
the batch; the loss's normalisers (the number of real boxes, the class
weights, the proposal counts) are summed over dp, as the DETR reference
sums its ``num_boxes``; the auction matcher runs per image, locally.  The
sp x tp ranks of a dp block each hold that block's loss, so each
backpropagates its share of it, and every gradient is then summed over the
ranks that hold its parameter.  ``shard_params`` cuts the attention
projections over tp (``_tp_spec_for``); ``replicate_params`` gives every
rank the same parameters.
"""

from __future__ import annotations

import functools
import warnings

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models import denoising
from ..utils.graphs import _same, graphed
from ..utils.profile import annotate
from .boxes import generalized_box_iou
from .matcher import auction_assignment, matching_cost
from .sharding import axis, sum_over

__all__ = ["detection_loss", "make_train_step", "replicate_params",
           "shard_params"]


def detection_loss(outputs, targets, matcher: str = "fixed",
                   aux_weight: float = 1.0, enc_weight: float = 1.0,
                   giou_weight: float = 2.0, class_loss: str = "ce",
                   eos_coef: float = 0.1, l1_weight: float = 5.0,
                   matcher_rounds: int = 2000,
                   return_metrics: bool = False, group=None,
                   class_cost_weight: float = 1.0):
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
    :func:`_enc_proposal_loss` scaled by ``enc_weight``, or, from the
    published two-stage form (``enc`` with ``top_idx``),
    :func:`_published_proposal_loss` so scaled, in the span
    ``proposal_loss``.  The DINO form's ``outputs["interm"]`` (its selected
    proposals) pay the decoder's loss, matched, scaled by ``enc_weight``;
    its ``outputs["dn"]`` (the denoising queries' predictions, every layer)
    pay :func:`_denoising_loss`, in the span ``dn_loss``.
    ``class_cost_weight`` scales the matching cost's class term (DINO's
    is 2).

    With ``return_metrics=True`` the call returns ``(loss, metrics)``, where
    ``metrics["matcher_converged"]`` is a bool tensor on the loss's device:
    False means some auction matching hit its ``matcher_rounds`` budget and
    fell back to per-target argmin.  It is not read back to the host here.

    ``group``: the process group over which the batch is split (dp).  The
    loss is then this rank's share of the whole batch's loss: its
    normalisers are summed over the group, so that the shares sum to the
    loss of the whole batch.
    """
    head_kw = dict(l1_weight=l1_weight, matcher_rounds=matcher_rounds,
                   group=group, class_cost_weight=class_cost_weight)
    loss, converged = _single_detection_loss(
        outputs, targets, matcher, giou_weight, class_loss, eos_coef,
        **head_kw)
    for aux_out in outputs.get("aux", ()):
        aux_loss, aux_conv = _single_detection_loss(
            aux_out, targets, matcher, giou_weight, class_loss, eos_coef,
            **head_kw)
        loss = loss + aux_weight * aux_loss
        converged = converged & aux_conv
    interm = outputs.get("interm")
    if interm is not None:
        interm_loss, interm_conv = _single_detection_loss(
            interm, targets, matcher, giou_weight, class_loss, eos_coef,
            **head_kw)
        loss = loss + enc_weight * interm_loss
        converged = converged & interm_conv
    if "dn" in outputs:
        with annotate("dn_loss"):
            loss = loss + _denoising_loss(
                outputs["dn"], outputs["dn_meta"], targets, aux_weight,
                giou_weight, class_loss, l1_weight=l1_weight, group=group)
    enc = outputs.get("enc")
    if enc is not None and "top_idx" in enc:
        with annotate("proposal_loss"):
            enc_loss, enc_conv = _published_proposal_loss(
                enc, targets, matcher, giou_weight, class_loss, eos_coef,
                l1_weight=l1_weight, matcher_rounds=matcher_rounds,
                group=group)
        loss = loss + enc_weight * enc_loss
        converged = converged & enc_conv
    elif enc is not None:
        loss = loss + enc_weight * _enc_proposal_loss(
            enc, targets, giou_weight=giou_weight, l1_weight=l1_weight,
            group=group)
    if return_metrics:
        return loss, {"matcher_converged": converged}
    return loss


def _total(x: torch.Tensor, group) -> torch.Tensor:
    """A normaliser summed over the ranks of ``group`` (none: ``x``).  It
    carries no gradient: it counts targets and class weights."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


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


def _enc_proposal_loss(enc, targets, giou_weight=2.0, l1_weight=5.0,
                       group=None):
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
    n_pos = _total(pos.sum(), group).clamp(min=1.0)
    n_neg = _total((1.0 - pos).sum(), group).clamp(min=1.0)
    obj_loss = (bce * pos).sum() / n_pos + (bce * (1.0 - pos)).sum() / n_neg

    sel = torch.gather(pboxes, 1, idx[..., None].expand(-1, -1, 4))
    l1 = (sel - tboxes).abs().sum(-1)
    n_real = _total(mask.sum(), group).clamp(min=1.0)
    loss = obj_loss + l1_weight * (l1 * mask).sum() / n_real
    if giou_weight:
        giou = generalized_box_iou(sel, tboxes)
        loss = loss + giou_weight * ((1.0 - giou) * mask).sum() / n_real
    return loss


def _published_proposal_loss(enc, targets, matcher, giou_weight=2.0,
                             class_loss="ce", eos_coef=0.1, l1_weight=5.0,
                             matcher_rounds=2000, group=None):
    """The published two-stage proposal loss (the official ``SetCriterion``'s
    ``enc_outputs`` term): every target's label set to class 0, the
    decoder's matching (``matcher``) over all I proposals, and the
    decoder's loss on them: the class loss over all I x K logits, L1 and
    GIoU on the matched proposals.  ``enc``: ``{"logits" [B, I, K],
    "boxes" [B, I, 4]}``.  With the auction matcher, I + M past
    ``cuda_matcher.MAX_SLOTS`` takes its large-N path.  Returns ``(loss,
    converged)``."""
    binary = dict(targets, labels=torch.zeros_like(targets["labels"]))
    return _single_detection_loss(
        {"logits": enc["logits"], "boxes": enc["boxes"]}, binary, matcher,
        giou_weight, class_loss, eos_coef, l1_weight=l1_weight,
        matcher_rounds=matcher_rounds, group=group)


def _denoising_loss(dn, meta, targets, aux_weight=1.0, giou_weight=2.0,
                    class_loss="focal", focal_alpha=0.25, focal_gamma=2.0,
                    l1_weight=5.0, group=None):
    """The DINO denoising loss (the official ``SetCriterion``'s ``_dn``
    terms), which matches nothing: each DN query's target is fixed by its
    place (``models.denoising.dn_targets``).  At each layer (the last, and
    ``aux_weight`` times each of ``dn["aux"]``): the sigmoid focal loss over
    every DN query, a positive copy of a real target toward its label and
    every other query (negatives, padding) toward no object, plus L1 and
    GIoU on the positives' boxes, each over the number of real targets
    times ``meta["groups"]``.  ``meta``: the model's ``dn_meta``."""
    if class_loss != "focal":
        raise ValueError("the denoising loss is DINO's sigmoid focal loss: "
                         f"class_loss must be 'focal', got {class_loss!r}")
    K = dn["logits"].shape[-1]
    labels, tboxes, positive = denoising.dn_targets(
        targets, meta["max_targets"], meta["groups"], K)
    pos = positive.to(dn["logits"].dtype)
    # every box is compared, the positives' alone counted: a placeholder
    # box where there is no target keeps GIoU finite
    tboxes = torch.where(positive[..., None], tboxes,
                         torch.full_like(tboxes, 0.5))
    onehot = F.one_hot(labels, K + 1)[..., :K].to(dn["logits"].dtype)
    n = _total(targets["mask"].to(pos.dtype).sum(), group).clamp(
        min=1.0) * meta["groups"]
    loss = 0.0
    for i, head in enumerate([dn, *dn["aux"]]):
        cls = _sigmoid_focal(head["logits"], onehot, focal_alpha,
                             focal_gamma).sum() / n
        l1 = ((head["boxes"] - tboxes).abs().sum(-1) * pos).sum() / n
        term = cls + l1_weight * l1
        if giou_weight:
            giou = generalized_box_iou(head["boxes"], tboxes)
            term = term + giou_weight * ((1.0 - giou) * pos).sum() / n
        loss = loss + (term if i == 0 else aux_weight * term)
    return loss


def _single_detection_loss(outputs, targets, matcher, giou_weight=2.0,
                           class_loss="ce", eos_coef=0.1,
                           focal_alpha=0.25, focal_gamma=2.0,
                           l1_weight=5.0, matcher_rounds=2000, group=None,
                           class_cost_weight=1.0):
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
                                 class_weight=class_cost_weight,
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

    n_real = _total(mask.sum(), group).clamp(min=1.0)
    if class_loss == "ce":
        ce = F.cross_entropy(logits.reshape(B * N, K),
                             full_labels.reshape(B * N),
                             reduction="none").reshape(B, N)
        w = torch.where(full_labels == no_object, eos_coef, 1.0).to(ce.dtype)
        cls = (ce * w).sum() / _total(w.sum(), group)
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


def replicate_params(model: nn.Module, mesh) -> nn.Module:
    """Give every rank of the mesh the same parameters: those of its first
    rank (coordinate 0 on every axis), broadcast along each axis in turn.
    Returns ``model``."""
    params = list(model.parameters())
    with torch.no_grad():
        for name in mesh.mesh_dim_names:
            size, _, group = axis(mesh, name)
            if size == 1 or not params:
                continue
            flat = torch.cat([p.reshape(-1) for p in params])
            dist.broadcast(flat, group=group, group_src=0)
            _unflatten(flat, params)
    return model


def _unflatten(flat: torch.Tensor, tensors) -> None:
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def _tp_spec_for(name: str, param: torch.Tensor) -> int | None:
    """The dimension of a parameter that tensor parallelism splits over the
    ``tp`` axis, by its ``state_dict`` name, or None (replicated).

    The attention projections have head-major layouts
    (``models/attention.py``), so a contiguous block is a block of heads:

      img_input_proj / query_input_proj   weight [out, in], bias [out]:
          split *out* (column-parallel: each tp rank computes its heads'
          features)
      query_output_proj                   weight [out, in(head-major)]:
          split *in* (row-parallel: the partial sums are summed over tp;
          the bias stays replicated and is added once, after the sum)

    Everything else (FFNs, heads, embeddings, norms) stays replicated.
    """
    last = name.rsplit(".", 1)[-1]
    if "img_input_proj" in name or "query_input_proj" in name:
        if last in ("weight", "bias"):
            return 0
    if "query_output_proj" in name and last == "weight" and param.ndim == 2:
        return 1
    return None


def _whole_shape(module: nn.Linear, last: str) -> tuple:
    return ((module.out_features, module.in_features) if last == "weight"
            else (module.out_features,))


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Replicate the parameters over the mesh (:func:`replicate_params`),
    then cut the attention projections over the ``tp`` axis
    (:func:`_tp_spec_for`): each rank keeps its block.  A projection stays
    whole where tp does not divide it.  Returns ``model``; build the
    optimizer on its parameters after this."""
    replicate_params(model, mesh)
    tp, t, _ = axis(mesh, "tp")
    if tp == 1:
        return model
    with torch.no_grad():
        for mname, module in model.named_modules():
            if not isinstance(module, nn.Linear):
                continue
            for last, p in module.named_parameters(recurse=False):
                dim = _tp_spec_for(f"{mname}.{last}", p)
                if (dim is not None and p.shape[dim] % tp == 0
                        and tuple(p.shape) == _whole_shape(module, last)):
                    p.data = p.data.chunk(tp, dim)[t].contiguous()
    return model


def _tp_blocks(model: nn.Module) -> set:
    """Ids of the parameters that hold a tp block (shard_params cut them):
    those smaller than their layer's whole shape."""
    return {id(p) for module in model.modules()
            if isinstance(module, nn.Linear)
            for last, p in module.named_parameters(recurse=False)
            if tuple(p.shape) != _whole_shape(module, last)}


def _sum_gradients(model: nn.Module, mesh) -> None:
    """Sum each parameter's gradient over the ranks that hold the
    parameter: every rank of the mesh, or, for a tp block, the dp and sp
    ranks of its tp coordinate.  One all-reduce a mesh axis for each of the
    two kinds."""
    blocks = _tp_blocks(model)
    buckets = {}
    for p in model.parameters():
        if p.grad is not None:
            axes = ("dp", "sp") if id(p) in blocks else ("dp", "sp", "tp")
            buckets.setdefault(axes, []).append(p.grad)
    for axes, grads in buckets.items():
        groups = [group for size, _, group in (axis(mesh, a) for a in axes)
                  if size > 1]
        if not groups:
            continue
        flat = torch.cat([g.reshape(-1) for g in grads])
        for group in groups:
            dist.all_reduce(flat, group=group)
        _unflatten(flat, grads)


def make_train_step(model, optimizer, img_shapes, matcher: str = "fixed",
                    aux_weight: float = 1.0, enc_weight: float = 1.0,
                    giou_weight: float = 2.0, class_loss: str = "ce",
                    eos_coef: float = 0.1, l1_weight: float = 5.0,
                    matcher_rounds: int = 2000,
                    return_metrics: bool = False, mesh=None,
                    class_cost_weight: float = 1.0):
    """Build a train step ``step(pyramid, targets) -> loss`` for ``model``
    (an ``nn.Module`` returning the outputs :func:`detection_loss` takes)
    and a ``torch.optim`` ``optimizer`` over its parameters.

    The step zeroes the gradients, runs the forward, the loss and the
    backward, and steps the optimizer; the last three in the profiler spans
    (``utils.profile.annotate``) "loss", "backward" and "optimizer", which
    the graphed step's replays carry as device spans.  Every
    :func:`detection_loss` knob is threaded through.
    ``step(pyramid, targets, max_targets)``, ``max_targets`` a host int
    (the batch's largest count of real targets), passes the targets to
    the model for the DINO form's denoising queries
    (``DeformableDetr(two_stage="dino")``); each value is a signature of
    its own below, and each call adds its DN queries to
    ``models.denoising.BUILT``.  ``torch.optim.AdamW(params, lr,
    weight_decay=1e-4)`` is the counterpart of the JAX demo's
    ``optax.adamw(lr)``: pass ``weight_decay`` explicitly, since optax's
    default is 1e-4 and torch's 1e-2.

    ``return_metrics=True`` makes the step return ``(loss, metrics)`` with
    ``metrics["matcher_converged"]``, a device tensor: nothing syncs with
    the host per step unless the caller reads it.  The returned loss is
    detached.

    ``img_shapes``: the pyramid's level shapes, host ints, or None to take
    each call's from its pyramid (``(h, w)`` of each level's tensor), so
    that one step trains at every input size of a multi-scale resize.

    When the model's parameters lie on a CUDA device and there is no mesh,
    the step is the counterpart of ``jax.jit``, ``utils.graphs.graphed``
    of the eager step: the first call for a set of input shapes and dtypes
    is an eager step on a side stream (it creates the optimizer's state and
    builds the kernels), the second captures one step into a
    ``torch.cuda.CUDAGraph`` over static copies of the inputs and replays
    it, and every later call copies the inputs in and replays.  The
    captures of all input shapes share one memory pool, and the step keeps
    at most ``utils.graphs.MAX_SIGNATURES`` of them (the least recently
    called dropped first).  Each call is one optimizer update; the loss
    and metrics are clones of the graph's outputs.  The optimizer must then
    be capturable: every param group sets ``capturable=True``
    (``torch.optim.AdamW(..., capturable=True)``), or it is
    ``torch.optim.SGD`` with a float ``lr``, whose state lies on the
    device; any other raises ``ValueError`` (SGD reads a tensor ``lr`` on
    the host at every step, which no graph can hold).  A capture bakes in
    the param groups' options that are not tensors (a float ``lr``, say)
    and the tensors it reads: a call that finds an option changed, a
    group's parameters, or a state tensor replaced (``load_state_dict``)
    captures the step again (as long as a capture takes), so that the
    change takes effect as in the eager step.  A tensor changed in place is
    read by the graph and needs no new capture.  So a learning-rate
    schedule stepped every call wants a tensor ``lr`` on the card::

        opt = torch.optim.AdamW(model.parameters(),
                                lr=torch.tensor(2e-4, device="cuda"),
                                weight_decay=1e-4, capturable=True)
        schedule = torch.optim.lr_scheduler.LambdaLR(opt, warmup)
        step = make_train_step(model, opt, None)
        for pyramid, targets in batches:
            loss = step(pyramid, targets)  # one capture per input shape
            schedule.step()  # writes the lr tensor in place (fill_)

    as ``optax`` computes a schedule's lr inside the jitted step from its
    count: each replay reads the lr the scheduler last wrote (``LambdaLR``
    writes it on the device, with no host sync).
    A float ``lr`` changed every call captures every call; the first time
    a float ``lr`` is found changed, the step warns (once) and names this
    form.  The inputs must be tensors (``targets`` a dict of them), and the
    model's parameters keep their storage (update them in place, as
    ``load_state_dict`` does).  The kernels' launch counters
    (``ops.launches``) gain the captured step's launches at each replay.
    ``step.__wrapped__`` is the eager step, as ``jax.jit`` exposes the
    function it wraps.

    With a device ``mesh`` (``parallel.make_mesh``; the model built with
    the same one, its parameters placed by :func:`shard_params` or
    :func:`replicate_params`), each rank calls the step with its dp block
    of the batch, and the step equals one step of the unsharded model over
    the whole batch (the module docstring): every rank returns the whole
    batch's loss, and ``matcher_converged`` holds for the whole batch.  The
    mesh step runs eagerly (its collectives are not captured).
    """
    loss_kw = dict(matcher=matcher, aux_weight=aux_weight,
                   enc_weight=enc_weight, giou_weight=giou_weight,
                   class_loss=class_loss, eos_coef=eos_coef,
                   l1_weight=l1_weight, matcher_rounds=matcher_rounds,
                   return_metrics=True, class_cost_weight=class_cost_weight)
    copies = 1
    if mesh is not None:
        dp, _, dp_group = axis(mesh, "dp")
        copies = axis(mesh, "sp")[0] * axis(mesh, "tp")[0]
        loss_kw["group"] = dp_group if dp > 1 else None

    def step(pyramid, targets, max_targets=None):
        optimizer.zero_grad(set_to_none=True)
        shapes = (img_shapes if img_shapes is not None else
                  tuple(tuple(level.shape[1:3]) for level in pyramid))
        if max_targets is None:
            outputs = model(pyramid, shapes)
        else:
            outputs = model(pyramid, shapes, targets=targets,
                            max_targets=max_targets)
        with annotate("loss"):
            loss, metrics = detection_loss(outputs, targets, **loss_kw)
        with annotate("backward"):
            # the sp x tp ranks of a dp block hold the same loss: their
            # shares of it sum to it
            (loss / copies if copies > 1 else loss).backward()
            if mesh is not None:
                _sum_gradients(model, mesh)
        with annotate("optimizer"):
            optimizer.step()
        loss = loss.detach()
        if mesh is not None:
            loss = sum_over(loss, mesh, "dp")
            if return_metrics:
                ok = metrics["matcher_converged"].to(torch.int32)
                metrics["matcher_converged"] = (
                    sum_over(ok, mesh, "dp") == axis(mesh, "dp")[0])
        if return_metrics:
            return loss, metrics
        return loss

    device = _param_device(model)
    if mesh is not None or device.type != "cuda":
        run = step
    else:
        _check_capturable(optimizer)
        run = graphed(step, options=_options_reader(optimizer))

    def counted(pyramid, targets, max_targets=None):
        if max_targets:  # the DINO form's DN queries, counted on the host
            denoising.BUILT += (pyramid[0].shape[0]
                                * denoising.cdn_shape(max_targets)[1])
        return run(pyramid, targets, max_targets)

    functools.update_wrapper(counted, run)  # its name, stats(), cache_size()
    counted.__wrapped__ = step
    return counted


def _param_device(model: nn.Module) -> torch.device:
    """The device of the model's first parameter (the CPU without one)."""
    return next(model.parameters(), torch.empty(0)).device


def _check_capturable(optimizer) -> None:
    """Raise ``ValueError`` unless ``optimizer``'s update can be captured:
    every param group has ``capturable=True``, or it is ``SGD`` (its
    momentum buffers lie on the device; it keeps nothing on the host) with
    float learning rates (it reads a tensor ``lr`` on the host,
    ``alpha=-lr``)."""
    if type(optimizer) is torch.optim.SGD:
        if any(isinstance(group["lr"], torch.Tensor)
               for group in optimizer.param_groups):
            raise ValueError(
                "the step on a CUDA device is captured as a CUDA graph, and "
                "torch.optim.SGD reads a tensor lr on the host at every "
                "step (alpha=-lr), which a graph cannot hold: give SGD a "
                "float lr (a changed float lr captures the step again), or "
                "schedule a tensor lr with torch.optim.AdamW(..., "
                "lr=torch.tensor(lr, device=...), capturable=True)")
        return
    for group in optimizer.param_groups:
        if group.get("capturable") is not True:
            raise ValueError(
                "the step on a CUDA device is captured as a CUDA graph: "
                "build the optimizer with capturable=True (e.g. "
                "torch.optim.AdamW(..., capturable=True)) or use "
                f"torch.optim.SGD; {type(optimizer).__name__} has "
                f"capturable={group.get('capturable', 'unset')}")


def _options(optimizer) -> list:
    """What a capture reads of ``optimizer``: a copy of each param group,
    its parameter list included, and of each of its parameters' state."""
    return [(dict(group, params=list(group["params"])),
             [dict(optimizer.state.get(p, {})) for p in group["params"]])
            for group in optimizer.param_groups]


def _options_reader(optimizer):
    """``_options`` of ``optimizer`` as ``graphed``'s ``options`` hook.  The
    first reading that finds a param group's float ``lr`` changed since the
    reading before it (the step captures again) warns, once, of the tensor
    lr that a schedule can change without a capture."""
    last, warned = [], False

    def read() -> list:
        nonlocal last, warned
        reading = _options(optimizer)
        lrs = [group["lr"] for group, _ in reading]
        if not warned and any(
                not isinstance(now, torch.Tensor) and not _same(now, before)
                for now, before in zip(lrs, last)):
            warned = True
            warnings.warn(
                "a param group's float lr changed, so the graphed train step "
                "is captured again (as long as a capture takes); a schedule "
                "that changes lr every step captures every step.  Schedule "
                "a tensor lr instead, which the graph reads in place: "
                "torch.optim.AdamW(..., lr=torch.tensor(lr, device=...), "
                "capturable=True)", stacklevel=3)
        last = lrs
        return reading

    return read
