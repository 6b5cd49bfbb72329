"""Training DINO (``DeformableDetr(two_stage="dino")``): ``make_train_step``
(on a card, the step captured as a CUDA graph per batch shape and
replayed) with the configuration's loss, its interm and denoising terms
included, and AdamW, fed a fresh pooled batch a step with its largest count
of real targets as a host int, as ``drivers/train2s.py`` trains the
published two-stage detector, whose functions this driver takes where they
fit.

The denoising queries' shape follows that count (``2 * dn_number // (2 m)``
groups of ``2 m`` queries), so the pool's batches make up to as many
signatures of the graphed step as they hold counts.  The set-up drives the
step through the first ``checked_steps`` steps, keeping what
``drivers/train.py`` keeps, and then calls it until every signature of the
pool has been warmed up and captured, so that the window replays alone:
first the signatures not yet warmed up, then their captures.  Each warm-up
(a signature's first call, eager) hands its cached blocks back to the
device (``torch.cuda.empty_cache``), so that no capture's pool stacks on
the blocks of an eager step.

A forward hook keeps, by signature, the step's selection of proposals
(``proposals["top_idx"]``), the encoder's class logits over every token,
the denoising queries' random draws and their last layer's outputs (on a
card, the captured graph's own tensors, which each replay rewrites); a
clone of each is taken after each checked step.  The check runs the
reference (``reference.detr_dino``, ``reference.loss_dino``,
``reference.adamw``) through the same steps from the same weights, in f32
with TF32 off, each step decoded from the **program's** selection and
noised from the **program's** draws, so that the noising arithmetic is
compared and near-ties at rank ``num_queries`` do not fail a sound
program; ``selection_gap`` judges the selection apart (``drivers/
train2s.py``; the score here is a token's highest class logit).

Two numbers read the first step's forward alone: ``proposal_err`` (the
encoder's class logits ``[B, I, K]``) and ``dn_err`` (the last layer's DN
logits and boxes), each the norm of the difference over the reference's
norm, the larger of the two parts for ``dn_err``.  The first gradient
jumps between two sound programs where a ReLU's input lies within
rounding of 0 (``drivers/train2s.py``), so ``grad_gap`` holds out the
faults, not TF32; ``grad_err``, the median leaf's, holds out TF32 too.

The reference noises the program's own draws, so two numbers hold the
draws to their laws (:func:`draw_checks`): ``draw_outside``, the share of
draws outside their range, and ``draw_z``, the farthest a draw's mean or
spread lies from its law's, in standard errors.

A program without the DINO form is refused at the start of the set-up.
``calibrate.py`` finds this driver's readings by its name
(``calibration_readings``).
"""

from __future__ import annotations

import math
import sys

import torch

from perfbench import harness, inputs, inputs_dino
from perfbench.drivers import train, train2s
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import detr_dino as ref_detr
from perfbench.reference import loss_dino as ref_loss

TRAFFIC = train.TRAFFIC
CONFIG = {"two_stage": ("dino",)}
drain, release = train.drain, train.release
#: the faults ``calibration_readings`` plants in the reference
FAULTS = {"mask_dropped": {"masked": False},
          "detached": {"look_twice": False},
          "noise_off": {"noise": False}}
#: wrong laws of the draws ``calibration_readings`` puts in the program's:
#: signs in {0, 1}, magnitudes in [0, 1/2), labels over half the classes,
#: flips in [0, 1/2)
DRAW_FAULTS = {
    "signs_01": lambda d, K: dict(d, sign=(d["sign"] + 1) / 2),
    "part_half": lambda d, K: dict(d, part=d["part"] / 2),
    "labels_half": lambda d, K: dict(d, label=d["label"] // 2),
    "flip_half": lambda d, K: dict(d, flip=d["flip"] / 2)}


def _model(cfg: dict, device):
    """``DeformableDetr(two_stage="dino")`` as the configuration states."""
    from msda_tpu_torch.models import DeformableDetr

    return DeformableDetr(
        num_classes=cfg["num_classes"], in_channels=tuple(cfg["in_channels"]),
        emb_dim=cfg["emb_dim"], num_heads=cfg["num_heads"],
        num_points=cfg["num_points"], num_queries=cfg["num_queries"],
        num_encoder_layers=cfg["num_encoder_layers"],
        num_decoder_layers=cfg["num_decoder_layers"], ffn_dim=cfg["ffn_dim"],
        with_box_refinement=cfg["with_box_refinement"], two_stage="dino",
        device=device)


def _require_dino_form(cfg) -> None:
    """Refuse, before any weight is made, a program whose ``DeformableDetr``
    has no DINO form, or one with other parameters than this one's."""
    try:
        model = _model(cfg, "meta")
    except (TypeError, ValueError) as e:
        raise harness.Refused(f"the program has no DINO form of its "
                              f"detector: {e}") from e
    want = {name for name, _, _ in inputs_dino.detector_spec(cfg)}
    if set(model.state_dict()) != want:
        raise harness.Refused(
            "the program's DeformableDetr(two_stage='dino') is not this DINO "
            "form: its parameters differ by "
            f"{sorted(set(model.state_dict()) ^ want)[:6]}")


def batches(ctx):
    """``train.batches`` with each batch's largest count of real targets,
    read once here, as the data loader knows it."""
    return [(pyramid, targets, int(targets["mask"].sum(1).max()))
            for pyramid, targets in train.batches(ctx)]


def unit(st, i):
    k = (st["first"] + i) % len(st["pool"])
    st["step"](*st["pool"][k])


def setup(ctx):
    from msda_tpu_torch.parallel import make_train_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    _require_dino_form(cfg)
    start = inputs_dino.detector_weights(cfg, ctx.seed, dev)
    ctx.mark("weights from the seed")
    model = _model(cfg, dev)
    model.load_state_dict(start, strict=True)
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
        matcher_rounds=lc["matcher_rounds"],
        class_cost_weight=lc["class_cost"])
    ctx.mark("the program's model, optimizer and step")
    pool = batches(ctx)
    ctx.mark("batch pool")
    kept = {}

    def keep(module, args, kwargs, out):
        kept[kwargs.get("max_targets")] = (
            out["proposals"]["top_idx"], out["proposals"]["logits"].detach(),
            out["dn"]["draws"], out["dn"]["logits"].detach(),
            out["dn"]["boxes"].detach())

    hook = model.register_forward_hook(keep, with_kwargs=True)
    losses, grads, selection, draws, calls = [], None, [], [], {}

    def call(batch):
        """A step on ``batch``; a warm-up's cached blocks freed after it."""
        out = step(*batch)
        calls[batch[2]] = calls.get(batch[2], 0) + 1
        if calls[batch[2]] == 1 and dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    for k in range(tr["checked_steps"]):
        m = pool[k][2]
        losses.append(call(pool[k]))
        top_idx, logits, drawn, dn_logits, dn_boxes = kept[m]
        selection.append(top_idx.clone())
        draws.append({n: t.clone() for n, t in drawn.items()})
        if k == 0:
            first = {"proposal_logits": logits.clone(),
                     "dn": {"logits": dn_logits.clone(),
                            "boxes": dn_boxes.clone()}}
        ctx.mark(("first step, eager (kernel builds and loads)",
                  "second step", "third step")[min(k, 2)])
        if k == 0:
            grads = {n: train._first_grad(opt, p, o["betas"][0])
                     for n, p in zip(names, model.parameters())}
    hook.remove()
    kept.clear()
    change = {n: p.detach() - start[n]
              for n, p in zip(names, model.parameters())}
    # every signature of the pool warmed up, then captured, before the window
    rest = [pool[k % len(pool)] for k in range(tr["checked_steps"],
                                               tr["checked_steps"]
                                               + len(pool))]
    for want in (1, 2):
        for batch in rest:
            if calls.get(batch[2], 0) < want:
                call(batch)
    ctx.mark("every other signature warmed up and captured")
    ctx.selection, ctx.draws = selection, draws
    return dict(ctx=ctx, model=model, opt=opt, step=step, pool=pool,
                first=tr["checked_steps"], pads=[
                    2 * ref_detr.dn_groups(m, cfg["dn"]["number"]) * m
                    for _, _, m in pool],
                program={"losses": [float(x) for x in losses],
                         "grads": grads, "change": change,
                         "top_idx": selection, **first})


def reference(ctx, pool, tf32=False, half_batch=False, **fault) -> dict:
    """The reference's readings through the checked steps, each decoded from
    the program's selection and noised from the program's draws
    (``ctx.selection``, ``ctx.draws``): losses, first gradients, changes,
    each step's token scores (``logit0``, for ``train2s.selection_gap``)
    and the selection decoded (``top_idx``), and the first step's encoder
    logits and last DN layer.  ``tf32`` and
    ``half_batch`` as ``train.reference``'s; ``fault`` a keyword fault of
    ``reference.detr_dino.forward`` (``FAULTS``)."""
    cfg, tr = ctx.config, ctx.traffic
    o, Q = cfg["optimizer"], cfg["num_queries"]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        start = inputs_dino.detector_weights(cfg, ctx.seed, ctx.device)
        params = {n: t.clone().requires_grad_() for n, t in start.items()}
        opt = ref_adamw.AdamW(params, o["lr"], o["weight_decay"],
                              tuple(o["betas"]), o["eps"])
        out = {"losses": [], "logit0": [], "top_idx": []}
        first = None
        for k in range(tr["checked_steps"]):
            pyramid, targets, _ = pool[k]
            forced, drawn = ctx.selection[k], ctx.draws[k]
            if half_batch:
                pyramid = [f[:1] for f in pyramid]
                targets = {n: t[:1] for n, t in targets.items()}
                forced = forced[:1]
                drawn = {n: t[:1] for n, t in drawn.items()}
            if tuple(forced.shape) != (pyramid[0].shape[0], Q):
                forced = None  # no selection of this batch: its own
            det = ref_detr.forward(params, cfg, pyramid, remat=True,
                                   top_idx=forced, targets=targets,
                                   draws=drawn, **fault)
            loss = ref_loss.detection_loss(det, targets, cfg["loss"])
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {n: g if g is not None else torch.zeros_like(params[n])
                     for n, g in grads.items()}
            out["logit0"].append(det["scores"].detach())
            out["top_idx"].append(det["top_idx"])
            if k == 0:
                first = grads
                out["proposal_logits"] = det["enc_logits"].detach()
                out["dn"] = {"logits": det["dn"]["logits"].detach(),
                             "boxes": det["dn"]["boxes"].detach()}
            opt.step(grads)
            out["losses"].append(float(loss.detach()))
        out["grads"] = first
        out["change"] = {n: p.detach() - start[n] for n, p in params.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        torch.backends.cudnn.allow_tf32 = before
    return out


def dn_err(prog: dict, ref: dict) -> float:
    """The larger, of the first step's last-layer DN logits and boxes, of
    the norm of the difference over the reference's norm, over the images
    both hold."""
    errs = []
    for part in ("logits", "boxes"):
        got, want = prog["dn"][part], ref["dn"][part]
        images = min(got.shape[0], want.shape[0])
        got, want = got[:images], want[:images]
        errs.append(float((got - want).norm() / want.norm()))
    return max(errs)


def compare(prog: dict, ref: dict) -> dict:
    """``train2s.compare``'s numbers and ``dn_err``."""
    return dict(train2s.compare(prog, ref), dn_err=dn_err(prog, ref))


def draw_checks(draws: list, num_classes: int) -> dict:
    """The checked steps' random draws (``ctx.draws``) against their laws:
    ``flip`` and ``part`` uniform in [0, 1), ``label`` uniform over the
    ``num_classes`` classes, ``sign`` -1 or 1 with even odds.
    ``draw_outside``: the share of the draws outside their range (a label
    not a whole class, a sign neither -1 nor 1 among them); ``draw_z``:
    over the draws, the farthest the mean, or the mean square about the
    law's mean, lies from the law's, in standard errors (the sign's mean
    alone, its square being 1)."""
    K = num_classes
    u = (0.5, 1 / 12, 1 / 80)  # mean, variance, fourth central moment
    laws = {"flip": u, "part": u,
            "label": ((K - 1) / 2, (K * K - 1) / 12,
                      (K * K - 1) * (3 * K * K - 7) / 240),
            "sign": (0.0, 1.0, 1.0)}
    outside, count, z = 0, 0, 0.0
    for name, (mean, var, m4) in laws.items():
        x = torch.cat([d[name].flatten() for d in draws]).double()
        if name == "label":
            ok = (x >= 0) & (x < K) & (x == x.round())
        elif name == "sign":
            ok = x.abs() == 1
        else:
            ok = (x >= 0) & (x < 1)
        outside += int((~ok).sum())
        count += x.numel()
        root_n = math.sqrt(x.numel())
        z = max(z, float((x.mean() - mean).abs()) / math.sqrt(var) * root_n)
        if m4 > var * var:
            square = ((x - mean) ** 2).mean()
            z = max(z, float((square - var).abs())
                    / math.sqrt(m4 - var * var) * root_n)
    return {"draw_outside": outside / count, "draw_z": z}


def check(st) -> dict:
    release(st)
    ctx = st["ctx"]
    return dict(compare(st["program"], reference(ctx, st["pool"])),
                **draw_checks(ctx.draws, ctx.config["num_classes"]))


def calibration_readings(cell, st) -> dict:
    """``calibrate.py``'s readings of a seed: the program's numbers, the
    TF32 control's, and the faults': each batch's first image alone, the
    state left unchanged, ``FAULTS`` (the group mask dropped, look forward
    twice detached, the DN queries without noise), each in the program's
    place, and ``DRAW_FAULTS`` in the program's draws."""
    release(st)
    ctx, pool, prog = st["ctx"], st["pool"], st["program"]
    K = ctx.config["num_classes"]
    drawn = draw_checks(ctx.draws, K)
    ref = reference(ctx, pool)
    unchanged = dict(prog, change={n: torch.zeros_like(t)
                                   for n, t in ref["change"].items()})
    faults = {"half_batch": compare(reference(ctx, pool, half_batch=True),
                                    ref),
              "unchanged": compare(unchanged, ref)}
    for name, fault in FAULTS.items():
        faults[name] = compare(reference(ctx, pool, **fault), ref)
    faults = {name: dict(r, **drawn) for name, r in faults.items()}
    sound = compare(prog, ref)
    for name, fault in DRAW_FAULTS.items():
        faults[name] = dict(sound, **draw_checks(
            [fault(d, K) for d in ctx.draws], K))
    return {"program": dict(sound, **drawn),
            "control": dict(compare(reference(ctx, pool, tf32=True), ref),
                            **drawn),
            "faults": faults}


def _offer_readings() -> None:
    """Put ``calibration_readings`` into ``calibrate.py``'s table of
    readings by driver, where calibrate is loaded (as a module or as the
    script run)."""
    for name in ("perfbench.calibrate", "__main__"):
        table = getattr(sys.modules.get(name), "READINGS", None)
        if isinstance(table, dict) and "train" in table:
            table.setdefault("traindn", calibration_readings)


_offer_readings()
