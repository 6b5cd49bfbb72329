"""Training the detector: ``msda_tpu_torch.parallel.make_train_step`` (on
a card, the step captured as a CUDA graph and replayed) with the
configuration's loss and AdamW, fed a fresh pooled batch a step.

The set-up builds the one step object and drives it through the first
``checked_steps`` steps, each on another batch, through the same call as
the window; it keeps what the check compares: each step's loss, each
parameter's first gradient as the optimizer holds it (AdamW's first
moment after one step is ``(1 - beta1)`` times it) and, before the window
steps again, each parameter's change since the start.  A unit is one step
call, with no sync; the window ends with one.

The check runs the reference (``reference.detr``, ``reference.loss``,
``reference.adamw``) through the same steps from the same weights and
batches, in f32 with TF32 off, and compares (``compare``).

The step runs in f32: a traffic mix that asks for another
``compute_dtype`` is refused (``TRAFFIC``).
"""

from __future__ import annotations

import statistics

import torch

from perfbench import inputs, program
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import detr as ref_detr
from perfbench.reference import loss as ref_loss

#: a parameter whose first reference gradient is below this share of the
#: median parameter's moves by rounding alone under Adam: its change is
#: not compared
MOVING = 1e-3
#: the traffic keys this driver reads, with the values it supports (None:
#: any); the harness refuses a mix with another key or value
TRAFFIC = {"batch": None, "size": None, "compute_dtype": ("float32",),
           "pool": None, "target_slots": None, "real_targets": None,
           "box_wh": None, "checked_steps": None}


def batches(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    return [(inputs.pyramid(cfg, tr["size"], tr["batch"], inputs.generator(
                 ctx.seed, dev, "pyramid", k), dev),
             inputs.targets(cfg, tr, inputs.generator(ctx.seed, dev,
                                                      "targets", k), dev))
            for k in range(tr["pool"])]


def setup(ctx):
    from msda_tpu_torch.parallel import make_train_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    start = inputs.detector_weights(cfg, ctx.seed, dev)
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
        aux_weight=lc["aux_weight"], l1_weight=lc["l1_weight"],
        giou_weight=lc["giou_weight"], matcher_rounds=lc["matcher_rounds"])
    ctx.mark("the program's model, optimizer and step")
    pool = batches(ctx)
    ctx.mark("batch pool")
    losses, grads = [], None
    for k in range(tr["checked_steps"]):
        losses.append(step(*pool[k]))
        ctx.mark(("first step, eager (kernel builds and loads)",
                  "second step: the capture and a replay",
                  "third step, a replay")[min(k, 2)])
        if k == 0:
            grads = {n: _first_grad(opt, p, o["betas"][0])
                     for n, p in zip(names, model.parameters())}
    change = {n: p.detach() - start[n]
              for n, p in zip(names, model.parameters())}
    return dict(ctx=ctx, model=model, opt=opt, step=step, pool=pool,
                first=tr["checked_steps"],
                program={"losses": [float(x) for x in losses],
                         "grads": grads, "change": change})


def _first_grad(opt, p, b1) -> torch.Tensor:
    """The gradient AdamW took in its first step, from its first moment
    ``(1 - b1) * grad``; zeros where it holds none."""
    m = opt.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m / (1 - b1)


def unit(st, i):
    k = (st["first"] + i) % len(st["pool"])
    st["step"](*st["pool"][k])


def drain(st):
    if st["ctx"].device.type == "cuda":
        torch.cuda.synchronize()


def reference(ctx, pool, tf32=False, half_batch=False) -> dict:
    """The reference's first steps from the seed's weights on the pool's
    batches: losses, first gradients, changes.  ``tf32`` runs
    its products in TF32 (a control); ``half_batch`` trains on each
    batch's first image alone (a fault)."""
    cfg, tr = ctx.config, ctx.traffic
    o = cfg["optimizer"]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        start = inputs.detector_weights(cfg, ctx.seed, ctx.device)
        params = {n: t.clone().requires_grad_() for n, t in start.items()}
        opt = ref_adamw.AdamW(params, o["lr"], o["weight_decay"],
                              tuple(o["betas"]), o["eps"])
        losses, first = [], None
        for k in range(tr["checked_steps"]):
            pyramid, targets = pool[k]
            if half_batch:
                pyramid = [f[:1] for f in pyramid]
                targets = {n: t[:1] for n, t in targets.items()}
            out = ref_detr.forward(params, cfg, pyramid, remat=True)
            loss = ref_loss.detection_loss(out, targets, cfg["loss"])
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {n: g if g is not None else torch.zeros_like(params[n])
                     for n, g in grads.items()}
            if k == 0:
                first = grads
            opt.step(grads)
            losses.append(float(loss.detach()))
        change = {n: p.detach() - start[n] for n, p in params.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        torch.backends.cudnn.allow_tf32 = before
    return {"losses": losses, "grads": first, "change": change}


def compare(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the widest relative gap of a step's loss.
    ``grad_gap``: the widest gap of a parameter's first-gradient norm,
    over the larger of the reference's norm and the median parameter's.
    ``change_gap``: the same of the change over the steps, over the
    parameters whose first reference gradient is at least ``MOVING`` of
    the median's.  ``grad_err``: the median parameter's norm of the first
    gradient's difference over the reference's norm (a gap of norms
    hardly sees errors that are spread over every element, as TF32's
    are)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    norm = {key: {n: float(t.norm()) for n, t in ref[key].items()}
            for key in ("grads", "change")}
    med = statistics.median(norm["grads"].values())
    moving = [n for n in norm["grads"] if norm["grads"][n] >= MOVING * med]

    def widest(key, names):
        r = norm[key]
        m = statistics.median(r[n] for n in names)
        return max(abs(float(prog[key][n].norm()) - r[n]) / max(r[n], m)
                   for n in names)

    grad_err = statistics.median(
        float((prog["grads"][n] - g).norm()) / norm["grads"][n]
        for n, g in ref["grads"].items() if norm["grads"][n] > 0)
    return {"loss_gap": loss_gap,
            "grad_gap": widest("grads", list(norm["grads"])),
            "grad_err": grad_err, "change_gap": widest("change", moving)}


def release(st):
    st["step"] = st["model"] = st["opt"] = None
    del st["pool"][st["first"]:]
    if st["ctx"].device.type == "cuda":
        torch.cuda.empty_cache()


def check(st) -> dict:
    release(st)
    return compare(st["program"], reference(st["ctx"], st["pool"]))
