"""Training the published two-stage detector
(``DeformableDetr(two_stage="published")``): ``make_train_step`` (on a
card, the step captured as a CUDA graph and replayed) with the
configuration's loss, its proposal term included, and AdamW, fed a fresh
pooled batch a step, as ``drivers/train.py`` trains the one-stage detector,
whose functions this driver takes where they fit.

The set-up builds the step and drives it through the first
``checked_steps`` steps, keeping each step's loss, first gradients and
changes as ``train.setup`` does, and each step's selection of proposals:
a forward hook on the model keeps the ``enc["top_idx"]`` tensor of the
step's forward (on a card, the captured graph's own, which each replay
rewrites), and a clone of it is taken after each checked step.  The
selections reach the check as ``ctx.selection``.  The same hook keeps the
first step's proposal logits (``enc["logits"]``, from the eager first
step).

The check runs the reference (``reference.detr_two_stage``,
``reference.loss_two_stage``, ``reference.adamw``) through the same steps
from the same weights, in f32 with TF32 off, decoding each step from the
**program's** selection: top-k over 22,223 scores can swap near-ties at
rank 300 between two sound implementations, and the decoder's outputs,
the loss and the gradients are then compared on the same proposals.  The
selection is judged apart, by ``selection_gap``: over the checked steps and
images, the most by which the reference's logit 0 of a proposal the
program selected falls below the reference's 300th-best logit 0 (0 where
the sets agree).  A near-tie reads about the rounding of a logit; top-k on
another column, or proposals left unmasked, read a logit and more.

One number reads the forward alone: ``proposal_err``, the norm of the
difference of the first step's proposal logits ``[B, I, K]`` over the
reference's norm.  The forward is continuous in its rounding, so a sound
program reads about 1e-7 there on every seed and TF32 about 1e-4.  The
first gradient is not: on a seed in some 50 a ReLU's input lies within
f32 rounding of 0 where a large gradient flows, and the first gradient
of every layer below it jumps by up to about 1e-3 between two sound
programs (``PERF.md`` §2).  So ``grad_gap`` and ``grad_err`` have limits
above that jump and hold out the faults, not TF32, and the losses of the
steps after it, which inherit it, are not compared (``loss_gap`` read up
to 2.6e-3 on a sound program, under three times of room below the train
cell's 0.003).

A program whose detector has no published two-stage form is refused at
the start of the set-up.  ``calibrate.py`` finds this driver's readings
by its name (``calibration_readings``, offered to it when both are
loaded).
"""

from __future__ import annotations

import sys

import torch

from perfbench import harness, inputs, inputs_two_stage, program
from perfbench.drivers import train
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import detr_two_stage as ref_detr
from perfbench.reference import loss_two_stage as ref_loss

TRAFFIC = train.TRAFFIC
CONFIG = {"two_stage": ("published",)}
batches, unit, drain, release = (train.batches, train.unit, train.drain,
                                 train.release)


def _require_published_form(cfg) -> None:
    """Refuse, before any weight is made, a program whose
    ``DeformableDetr(two_stage="published")`` has other parameters than the
    published form's (one from before the form was added)."""
    from msda_tpu_torch.models import DeformableDetr

    try:
        model = DeformableDetr(
            num_classes=cfg["num_classes"],
            in_channels=tuple(cfg["in_channels"]), emb_dim=cfg["emb_dim"],
            num_heads=cfg["num_heads"], num_points=cfg["num_points"],
            num_queries=cfg["num_queries"],
            num_encoder_layers=cfg["num_encoder_layers"],
            num_decoder_layers=cfg["num_decoder_layers"],
            ffn_dim=cfg["ffn_dim"],
            with_box_refinement=cfg["with_box_refinement"],
            two_stage="published", device="meta")
    except (TypeError, ValueError) as e:
        raise harness.Refused(f"the program has no published two-stage "
                              f"detector: {e}") from e
    want = {name for name, _, _ in inputs_two_stage.detector_spec(cfg)}
    if set(model.state_dict()) != want:
        raise harness.Refused(
            "the program's DeformableDetr(two_stage='published') is not the "
            "published two-stage form: its parameters differ by "
            f"{sorted(set(model.state_dict()) ^ want)[:6]}")


def setup(ctx):
    from msda_tpu_torch.parallel import make_train_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    _require_published_form(cfg)
    start = inputs_two_stage.detector_weights(cfg, ctx.seed, dev)
    ctx.mark("weights from the seed")
    model = program.detector(cfg, start, dev)
    names = [n for n, _ in model.named_parameters()]
    o, lc = cfg["optimizer"], cfg["loss"]
    opt = torch.optim.AdamW(model.parameters(), lr=o["lr"],
                            betas=tuple(o["betas"]), eps=o["eps"],
                            weight_decay=o["weight_decay"],
                            capturable=dev.type == "cuda")
    step = make_train_step(
        model, opt, inputs.level_shapes(cfg, tr["size"]),
        matcher=lc["matcher"], class_loss=lc["class_loss"],
        aux_weight=lc["aux_weight"], enc_weight=lc["enc_weight"],
        l1_weight=lc["l1_weight"], giou_weight=lc["giou_weight"],
        matcher_rounds=lc["matcher_rounds"])
    ctx.mark("the program's model, optimizer and step")
    pool = batches(ctx)
    ctx.mark("batch pool")
    kept = []

    def keep(module, args, out):
        kept[:] = [out["enc"]["top_idx"], out["enc"]["logits"].detach()]

    hook = model.register_forward_hook(keep)
    losses, grads, selection = [], None, []
    for k in range(tr["checked_steps"]):
        losses.append(step(*pool[k]))
        selection.append(kept[0].clone())
        if k == 0:
            proposal_logits = kept[1].clone()
        ctx.mark(("first step, eager (kernel builds and loads)",
                  "second step: the capture and a replay",
                  "third step, a replay")[min(k, 2)])
        if k == 0:
            grads = {n: train._first_grad(opt, p, o["betas"][0])
                     for n, p in zip(names, model.parameters())}
    hook.remove()
    kept.clear()
    change = {n: p.detach() - start[n]
              for n, p in zip(names, model.parameters())}
    ctx.selection = selection
    return dict(ctx=ctx, model=model, opt=opt, step=step, pool=pool,
                first=tr["checked_steps"],
                program={"losses": [float(x) for x in losses],
                         "grads": grads, "change": change,
                         "top_idx": selection,
                         "proposal_logits": proposal_logits})


def reference(ctx, pool, tf32=False, half_batch=False,
              fault_selections=False) -> dict:
    """``train.reference``'s readings of the two-stage reference, each step
    decoded from the program's selection (``ctx.selection``; from its own
    where the program's is not one of ``num_queries`` proposals an image of
    the batch), per step the reference's logit 0 over every token
    (``logit0``) and its own selection (``top_idx``), and the first step's
    proposal logits (``proposal_logits``).  ``tf32`` and
    ``half_batch`` as there.  ``fault_selections`` adds the selections two
    faulty programs would make (``wrong_column``: top-k of logit 1;
    ``unmasked``: top-k with the invalid anchors' tokens left in the
    proposal heads)."""
    cfg, tr = ctx.config, ctx.traffic
    o, Q = cfg["optimizer"], cfg["num_queries"]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        start = inputs_two_stage.detector_weights(cfg, ctx.seed, ctx.device)
        params = {n: t.clone().requires_grad_() for n, t in start.items()}
        opt = ref_adamw.AdamW(params, o["lr"], o["weight_decay"],
                              tuple(o["betas"]), o["eps"])
        out = {"losses": [], "logit0": [], "top_idx": [], "wrong_column": [],
               "unmasked": []}
        first = None
        for k in range(tr["checked_steps"]):
            pyramid, targets = pool[k]
            forced = ctx.selection[k]
            if half_batch:
                pyramid = [f[:1] for f in pyramid]
                targets = {n: t[:1] for n, t in targets.items()}
                forced = forced[:1]
            if tuple(forced.shape) != (pyramid[0].shape[0], Q):
                forced = None  # no selection of this batch: its own
            det = ref_detr.forward(params, cfg, pyramid, remat=True,
                                   top_idx=forced)
            loss = ref_loss.detection_loss(det, targets, cfg["loss"])
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {n: g if g is not None else torch.zeros_like(params[n])
                     for n, g in grads.items()}
            logits = det["enc"]["logits"].detach()
            out["logit0"].append(logits[..., 0])
            out["top_idx"].append(logits[..., 0].topk(Q, dim=1).indices)
            if fault_selections:
                out["wrong_column"].append(
                    logits[..., 1].topk(Q, dim=1).indices)
                with torch.no_grad():
                    out["unmasked"].append(_unmasked_selection(
                        params, cfg, pyramid, Q))
            if k == 0:
                first = grads
                out["proposal_logits"] = logits
            opt.step(grads)
            out["losses"].append(float(loss.detach()))
        out["grads"] = first
        out["change"] = {n: p.detach() - start[n] for n, p in params.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        torch.backends.cudnn.allow_tf32 = before
    return out


def _unmasked_selection(params, cfg, pyramid, Q):
    """The top-``Q`` by logit 0 of proposal heads that leave the invalid
    anchors' tokens in (a fault)."""
    feats, shapes = ref_detr._encode(params, cfg, pyramid, ref_detr.identity,
                                     False)
    enc = ref_detr.proposals(params, cfg, feats, shapes, masked=False)
    return enc["logits"][..., 0].topk(Q, dim=1).indices


def selection_gap(prog: dict, ref: dict) -> float:
    """The most, over the steps and images, by which the reference's logit
    0 of a proposal the program selected falls below the reference's
    ``Q``-th best logit 0, over the images both hold; 0 where every
    selected proposal is among the reference's best ``Q``."""
    gap = 0.0
    for selected, logit0 in zip(prog["top_idx"], ref["logit0"]):
        images = min(selected.shape[0], logit0.shape[0])
        selected, logit0 = selected[:images], logit0[:images]
        kth = logit0.topk(selected.shape[1], dim=1).values[:, -1:]
        below = kth - logit0.gather(1, selected)
        gap = max(gap, float(below.max().clamp(min=0.0)))
    return gap


def proposal_err(prog: dict, ref: dict) -> float:
    """The norm of the difference of the first step's proposal logits over
    the reference's norm, over the images both hold."""
    got, want = prog["proposal_logits"], ref["proposal_logits"]
    images = min(got.shape[0], want.shape[0])
    got, want = got[:images], want[:images]
    return float((got - want).norm() / want.norm())


def compare(prog: dict, ref: dict) -> dict:
    """``train.compare``'s numbers but ``loss_gap``, ``selection_gap`` and
    ``proposal_err``."""
    out = train.compare(prog, ref)
    del out["loss_gap"]
    return dict(out, selection_gap=selection_gap(prog, ref),
                proposal_err=proposal_err(prog, ref))


def check(st) -> dict:
    release(st)
    return compare(st["program"], reference(st["ctx"], st["pool"]))


def calibration_readings(cell, st) -> dict:
    """``calibrate.py``'s readings of a seed: the program's numbers, the
    TF32 control's, and the faults' (``calibrate.train_readings``' two,
    and the selections of top-k on logit 1 and of unmasked proposals in
    the program's place)."""
    release(st)
    ctx, pool, prog = st["ctx"], st["pool"], st["program"]
    ref = reference(ctx, pool, fault_selections=True)
    unchanged = dict(prog, change={n: torch.zeros_like(t)
                                   for n, t in ref["change"].items()})
    return {"program": compare(prog, ref),
            "control": compare(reference(ctx, pool, tf32=True), ref),
            "faults": {
                "half_batch": compare(reference(ctx, pool, half_batch=True),
                                      ref),
                "unchanged": compare(unchanged, ref),
                "wrong_column": compare(
                    dict(prog, top_idx=ref["wrong_column"]), ref),
                "unmasked": compare(dict(prog, top_idx=ref["unmasked"]),
                                    ref)}}


def _offer_readings() -> None:
    """Put ``calibration_readings`` into ``calibrate.py``'s table of
    readings by driver, where calibrate is loaded (as a module or as the
    script run)."""
    for name in ("perfbench.calibrate", "__main__"):
        table = getattr(sys.modules.get(name), "READINGS", None)
        if isinstance(table, dict) and "train" in table:
            table.setdefault("train2s", calibration_readings)


_offer_readings()
