"""The MSDA op alone, as Deformable DETR's encoder calls it:
``msda_tpu_torch.multiscale_deformable_attention`` forward, then its
autograd backward for the three input gradients, on a pool of input sets
made at the set-up and cycled, so that no call finds the last call's
tensors in the L2 cache.

A unit is one call (forward in the span ``perfbench.fwd``, backward in
``perfbench.bwd``), with no sync; the window ends with one.  The check
takes ``checked_calls`` calls drawn from the seed among the first the
window is sure to make, and the last one, and compares their output and
gradients with the reference's, in f64 (``compare``).  The inputs are
f32, the configuration's ``dtype``.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import inputs
from perfbench.reference import msda as ref_msda

#: the keys this driver reads, with the values it supports (None: any);
#: the harness refuses a mix with another key or a value it does not
#: support, in the mix or in the configuration
TRAFFIC = {"batch": None, "size": None, "jitter_px": None, "pool": None,
           "checked_calls": None}
CONFIG = {"dtype": ("float32",)}


def setup(ctx):
    import msda_tpu_torch

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    pool = []
    for k in range(tr["pool"]):
        x = inputs.op_inputs(cfg, tr, inputs.generator(ctx.seed, dev, "pool",
                                                       k), dev)
        for name in ("img", "pts", "wts"):
            x[name].requires_grad_(True)
        pool.append(x)
    ctx.mark("input pool")
    st = dict(ctx=ctx, op=msda_tpu_torch.multiscale_deformable_attention,
              pool=pool, kept={}, last=None, keep=())
    x = pool[0]  # every kernel built and loaded
    out = st["op"](x["img"], x["shapes"], x["pts"], x["wts"],
                   cfg["padding_mode"], cfg["align_corners"])
    ctx.mark("first forward (K1's build and load)")
    torch.autograd.grad(out, (x["img"], x["pts"], x["wts"]), x["og"])
    ctx.mark("first backward (K2's build and load)")
    for k in range(tr["pool"]):
        call(st, pool[k])
    ctx.mark("a call on each input set")
    t0 = time.perf_counter()
    for k in range(tr["pool"]):
        call(st, pool[k])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / tr["pool"]
    ctx.mark("timed calls")
    # calls that any window of a second makes at a tenth of this speed
    sure = max(1, int(0.1 / max(per_call, 1e-6)))
    g = torch.Generator().manual_seed(inputs.sub_seed(ctx.seed, "check"))
    st["keep"] = set(torch.randperm(sure, generator=g)[
        :tr["checked_calls"]].tolist())
    return st


def call(st, x):
    cfg = st["ctx"].config
    with torch.profiler.record_function("perfbench.fwd"):
        out = st["op"](x["img"], x["shapes"], x["pts"], x["wts"],
                       cfg["padding_mode"], cfg["align_corners"])
    with torch.profiler.record_function("perfbench.bwd"):
        grads = torch.autograd.grad(out, (x["img"], x["pts"], x["wts"]),
                                    x["og"])
    return (out.detach(), *grads)


def unit(st, i):
    k = i % len(st["pool"])
    result = call(st, st["pool"][k])
    st["last"] = (k, result)
    if i in st["keep"]:
        st["kept"][i] = (k, result)


def drain(st):
    if st["ctx"].device.type == "cuda":
        torch.cuda.synchronize()


def compare(got, ref) -> dict:
    """For the output and each gradient, the largest error over the
    reference's largest magnitude."""
    names = ("out_err", "img_grad_err", "pts_grad_err", "wts_grad_err")
    return {n: float((g.double() - r).abs().amax() / r.abs().amax())
            for n, g, r in zip(names, got, ref)}


def reference(st, k):
    cfg, x = st["ctx"].config, st["pool"][k]
    return ref_msda.msda_with_grads(
        x["img"].detach(), x["shapes"], x["pts"].detach(), x["wts"].detach(),
        x["og"], cfg["padding_mode"], cfg["align_corners"])


def check(st) -> dict:
    """The widest errors over the kept calls."""
    calls = list(st["kept"].values()) + [st["last"]]
    st["kept"], st["last"] = {}, None
    refs, worst = {}, {}
    for k, got in calls:
        if k not in refs:
            refs[k] = reference(st, k)
        for n, v in compare(got, refs[k]).items():
            if math.isnan(v) or v > worst.get(n, 0.0):
                worst[n] = v
            worst.setdefault(n, v)
    return worst
