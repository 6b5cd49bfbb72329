"""Serving the detector: a user's serving function, the forward plus
``postprocess``, as one ``msda_tpu_torch.utils.graphs.graphed`` function
over every batch shape of the mix, called by one closed-loop client.

A unit is one request: the call (its host time, ``call_s``), then
``torch.cuda.synchronize()`` (its latency, ``latency_s``, from the call to
the return of the sync).  Each block of ``len(sizes)`` requests holds
every size once, in an order drawn from the seed; a request takes the
next of its size's pooled pyramids.  Every shape is warmed up and captured
in the set-up.

The pyramids are f32, whatever the model computes in.  The check: one
request of each size, drawn from the seed among those served, against
the reference's f32 forward of the same pyramid and its top-k decode by
sigmoid score (``compare``).
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import inputs, program
from perfbench.reference import detr as ref_detr

#: the traffic keys this driver reads, with the values it supports (None:
#: any); the harness refuses a mix with another key or value
TRAFFIC = {"batch": None, "compute_dtype": ("float32", "bfloat16"),
           "sizes": None, "pool_per_size": None, "top_k": None,
           "scoring": ("sigmoid",)}

def setup(ctx):
    from msda_tpu_torch.models import postprocess
    from msda_tpu_torch.utils import graphed

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    weights = inputs.detector_weights(cfg, ctx.seed, dev)
    ctx.mark("weights from the seed")
    model = program.detector(cfg, weights, dev,
                             program.dtype(tr["compute_dtype"])).eval()
    del weights
    ctx.mark("the program's model")

    def serve_fn(pyramid, image_sizes):
        return postprocess(model(pyramid, program.shapes_of(pyramid)),
                           top_k=tr["top_k"], scoring=tr["scoring"],
                           image_sizes=image_sizes)

    sizes = [tuple(s) for s in tr["sizes"]]
    B = tr["batch"]
    pools = [[inputs.pyramid(cfg, hw, B, inputs.generator(
        ctx.seed, dev, "pool", hw, j), dev)
        for j in range(tr["pool_per_size"])] for hw in sizes]
    image_sizes = [torch.tensor([hw] * B, device=dev) for hw in sizes]
    ctx.mark("pyramid pools")
    serve = graphed(serve_fn)
    with torch.inference_mode():
        for s in range(len(sizes)):
            for k in range(3):  # the warm-up, the capture, a replay
                serve(pools[s][0], image_sizes[s])
                if s == 0:
                    ctx.mark(("first eager call (kernel builds and loads)",
                              "first capture", "first replay")[k])
    ctx.mark("warm-ups and captures of the other sizes")
    st = dict(ctx=ctx, model=model, serve=serve, sizes=sizes, pools=pools,
              image_sizes=image_sizes,
              order=torch.Generator().manual_seed(
                  inputs.sub_seed(ctx.seed, "order")),
              block=[], served=[0] * len(sizes), requests=[], call_s=[],
              latency_s=[], outputs=[])
    return st


def _next(st) -> tuple[int, int]:
    """The size and pool entry of the next request."""
    if not st["block"]:
        st["block"] = torch.randperm(len(st["sizes"]),
                                     generator=st["order"]).tolist()
    s = st["block"].pop()
    j = st["served"][s] % len(st["pools"][s])
    st["served"][s] += 1
    return s, j


def unit(st, i):
    s, j = _next(st)
    st["requests"].append((s, j))
    cuda = st["ctx"].device.type == "cuda"
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = st["serve"](st["pools"][s][j], st["image_sizes"][s])
    t1 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    st["call_s"].append(t1 - t0)
    st["latency_s"].append(t2 - t0)
    st["outputs"].append(out)


def drain(st):
    if st["ctx"].device.type == "cuda":
        torch.cuda.synchronize()


def sample(st) -> list[int]:
    """One request of each size, drawn from the seed among those served."""
    g = torch.Generator().manual_seed(inputs.sub_seed(st["ctx"].seed,
                                                      "check"))
    picked = []
    for s in range(len(st["sizes"])):
        served = [i for i, r in enumerate(st["requests"]) if r[0] == s]
        if served:
            picked.append(served[int(torch.randint(len(served), (1,),
                                                   generator=g))])
    return picked


def reference_detections(cfg, tr, weights, pyramid, image_sizes,
                         rnd=ref_detr.identity) -> dict:
    """The reference's forward and top-k decode of one request."""
    with torch.no_grad():
        out = ref_detr.forward(weights, cfg, pyramid, rnd)
    return decode(out, tr["top_k"], image_sizes)


def decode(out, top_k, image_sizes) -> dict:
    """Top-``top_k`` (query, class) pairs by sigmoid score, boxes as
    absolute (x0, y0, x1, y1): ``scores``, ``labels``, ``boxes``, and the
    full ``logits`` and pixel ``all_boxes`` of every query."""
    logits, boxes = out["logits"].float(), out["boxes"].float()
    B, N, K = logits.shape
    scores, idx = torch.sigmoid(logits).reshape(B, N * K).topk(top_k, -1)
    h, w = image_sizes[:, 0].float(), image_sizes[:, 1].float()
    scale = torch.stack([w, h, w, h], -1)[:, None, :]
    cx, cy, bw, bh = boxes.unbind(-1)
    xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       -1) * scale
    q = idx // K
    return {"scores": scores, "labels": idx % K,
            "boxes": torch.gather(xyxy, 1, q[..., None].expand(-1, -1, 4)),
            "logits": logits, "all_boxes": xyxy}


def compare(served: dict, ref: dict, image_sizes) -> dict:
    """``score_gap``: the widest gap, in logits, between the served r-th
    best score and the reference's r-th best.  ``det_gap``: for each
    served detection, the reference's query nearest to it, by the logit
    gap at the served class plus the box gap as a share of the image's
    side (the queries' boxes differ, so this finds the query that served
    it); the widest such distance."""
    logit = torch.logit(served["scores"].double())
    score_gap = (logit - torch.logit(ref["scores"].double())).abs().amax()
    side = image_sizes.double().amax(-1)[:, None, None]  # [B, 1, 1]
    box = ((served["boxes"].double()[:, :, None, :]
            - ref["all_boxes"].double()[:, None, :, :]).abs().amax(-1)
           / side)  # [B, k, Q]
    B, k, Q = box.shape
    dev = box.device
    ref_logit = ref["logits"].double()[
        torch.arange(B, device=dev)[:, None, None],
        torch.arange(Q, device=dev)[None, None, :],
        served["labels"][:, :, None]]  # [B, k, Q]
    det_gap = ((logit[..., None] - ref_logit).abs() + box).amin(-1).amax()
    return {"score_gap": float(score_gap), "det_gap": float(det_gap)}


def release(st):
    """Free the program's state and every pyramid not in the sample."""
    keep = {st["requests"][i] for i in sample(st)}
    for s, pool in enumerate(st["pools"]):
        for j in range(len(pool)):
            if (s, j) not in keep:
                pool[j] = None
    st["serve"] = st["model"] = None
    if st["ctx"].device.type == "cuda":
        torch.cuda.empty_cache()


def check(st, rnd=ref_detr.identity) -> dict:
    """The widest gaps over the sampled requests."""
    ctx = st["ctx"]
    picked = sample(st)
    release(st)
    weights = inputs.detector_weights(ctx.config, ctx.seed, ctx.device)
    gaps = {"score_gap": 0.0, "det_gap": 0.0}
    for i in picked:
        s, j = st["requests"][i]
        sizes = st["image_sizes"][s]
        ref = reference_detections(ctx.config, ctx.traffic, weights,
                                   st["pools"][s][j], sizes)
        served = st["outputs"][i]
        if rnd is not ref_detr.identity:  # a control in the program's place
            served = reference_detections(ctx.config, ctx.traffic, weights,
                                          st["pools"][s][j], sizes, rnd)
        for k, v in compare(served, ref, sizes).items():
            gaps[k] = v if math.isnan(v) or v > gaps[k] else gaps[k]
    return gaps
