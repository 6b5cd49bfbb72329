#!/usr/bin/env python3
"""A/B timing of the port's K1 / K2 / streamed kernels against an earlier
version of their sources, on one NVIDIA GPU.

    git archive <commit> msda_tpu_torch/csrc | tar -x -C build/ab_parent
    python3 docs/experiments/torch_kernel_ab.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

The earlier sources are built with ``nvcc`` next to the current ones
(``msda_tpu_torch/csrc``) and swapped in through ``_build._LOADED``, so both
run behind the same Python wrappers (the C entry points keep their
signatures).  K1 and K2 are timed at Deformable DETR's encoder and decoder
shapes (``chip_smoke.py``'s ``OP_CASES``) in f32 and bf16, on uniform
points (``chip_smoke.op_inputs``) and on the points of the first encoder
and decoder layers of ``chip_smoke.py``'s full-width model
(``model_inputs``); the streamed kernels at the 256-base pyramid.  Each
kernel is timed in turns (old, new, new, old), two ways:

  * ``events``: CUDA events around the wrapper's calls, so the time holds
    whatever the host adds where it cannot keep the card busy;
  * ``device``: ``torch.profiler``'s device time of the kernel alone, and
    of every device operation of the call (K2's ``img_grad`` memset and
    casts included), per call.

The new kernels are checked against the old ones on the same inputs.
Prints one line per timing with the card's ``nvidia-smi`` name and power
limit, and writes them to ``--out`` (default ``build/kernel_ab/
kernel_ab.log``).  Needs a CUDA card and ``nvcc``; exits non-zero without
them.  ``torch_kernel_variants.py`` uses its building and timing to time
text-substituted variants of the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

import chip_smoke as cs  # noqa: E402
from msda_tpu_torch.ops import (_build, cuda_bwd, cuda_fwd,  # noqa: E402
                                cuda_stream)

OUT_DIR = os.path.join(ROOT, "build", "kernel_ab")
KERNEL_SYMBOL = {"msda_fwd": "msda_fwd_kernel", "msda_bwd": "msda_bwd_kernel"}
LOG = []


def log(msg: str) -> None:
    LOG.append(msg)
    print(msg, flush=True)


def write_log(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(LOG) + "\n")


def build(jobs: dict, include: dict) -> dict:
    """{(library, variant): source text} -> loaded libraries, one nvcc per
    source, all started together; logs each build's registers.
    ``include[(library, variant)]`` is the directory of its headers."""
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for (lib, variant), text in jobs.items():
        cu = os.path.join(OUT_DIR, f"{lib}_{variant}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT_DIR, f"lib{lib}_{variant}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", include[(lib, variant)],
               "-o", so, cu]
        procs.append(((lib, variant), so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for key, so, p in procs:
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}{out}")
        regs = sorted(set(re.findall(
            r"Used \d+ registers|\d+ bytes spill stores", err + out)))
        log(f"build {key[0]} {key[1]}: {', '.join(regs)}")
        libs[key] = ctypes.CDLL(so)
    return libs


def build_with_parent(parent: str, extra: dict | None = None,
                      extra_include: dict | None = None) -> dict:
    """The parent's three libraries as ``(lib, "old")``, the checkout's as
    ``(lib, "new")`` and ``extra`` sources besides."""
    jobs, include = dict(extra or {}), dict(extra_include or {})
    for lib in ("msda_fwd", "msda_bwd", "msda_stream"):
        with open(os.path.join(parent, lib + ".cu")) as f:
            jobs[(lib, "old")] = f.read()
        include[(lib, "old")] = parent
    libs = build(jobs, include)
    for lib in ("msda_fwd", "msda_bwd", "msda_stream"):
        libs[(lib, "new")] = _build.load_library(lib)
    return libs


def swap(lib: str, handle) -> None:
    _build._LOADED[lib] = handle
    if lib == "msda_stream":
        cuda_stream.load()


def device_ms(fn, iters: int, symbol: str | None) -> tuple[float, float]:
    """(kernel, whole call) device ms per call of ``fn`` under
    ``torch.profiler``: the summed device time of the events whose name
    holds ``symbol``, and of every device event; NaN where the profiler saw
    none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernel = total = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        total += us
        if symbol and symbol in e.name:
            kernel += us
    nan = float("nan")
    return ((kernel / iters / 1e3 if kernel else nan),
            (total / iters / 1e3 if total else nan))


def in_turns(fns: dict, iters: int, symbol: str | None = None) -> dict:
    """{name: fn} -> {name: {"events": (mean, first, second),
    "kernel": (...), "call": (...)}} in ms, timed a b ... b a."""
    names = list(fns)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append((cs.time_ms(fns[n], iters),
                        *device_ms(fns[n], iters, symbol)))
    out = {}
    for n, (r0, r1) in runs.items():
        out[n] = {k: ((r0[i] + r1[i]) / 2, r0[i], r1[i])
                  for i, k in enumerate(("events", "kernel", "call"))}
    return out


def log_turns(what: str, res: dict, smi: str) -> None:
    for v, r in res.items():
        parts = [f"{k} {m:.4f} ({a:.4f}, {b:.4f})" for k, (m, a, b) in
                 r.items()]
        log(f"ab {what} {v:28s} ms: {'; '.join(parts)}; old/this events "
            f"{res['old']['events'][0] / r['events'][0]:.2f}x on {smi}")


def model_inputs(call: int):
    """The arguments of the ``call``-th K1 launch of one forward of
    ``chip_smoke.py``'s full-width two-stage model (0: encoder layer 0, 6:
    decoder layer 0), and a seeded normal out_grad: the sampling pattern of
    the main path."""
    model = cs.build_model("cuda", True)
    seen, real = [], cuda_fwd.msda_fwd

    def spy(img, shapes, pts, wts, *args):
        seen.append((img, pts, wts))
        return real(img, shapes, pts, wts, *args)

    cuda_fwd.msda_fwd = spy
    try:
        with torch.inference_mode():
            model(cs.make_pyramid(30), cs.SLICE_SHAPES)
    finally:
        cuda_fwd.msda_fwd = real
    img, pts, wts = (t.clone() for t in seen[call])
    del model, seen
    rng = np.random.default_rng(8)
    og = torch.from_numpy(rng.standard_normal(
        tuple(img.shape[:1]) + tuple(pts.shape[1:3]) + tuple(img.shape[3:]),
        dtype=np.float32)).to(cs.DEVICE)
    return [img.float(), pts.float().contiguous(), wts.float().contiguous(),
            og]


# name, OP_CASES entry, inputs, launches per timing
CASES = (
    ("encoder", "encoder",
     lambda: cs.op_inputs(**cs.OP_CASES["encoder"], out_grad=True), 20),
    ("encoder_model", "encoder", lambda: model_inputs(0), 20),
    ("decoder", "decoder",
     lambda: cs.op_inputs(**cs.OP_CASES["decoder"], out_grad=True), 200),
    ("decoder_model", "decoder", lambda: model_inputs(6), 200),
)


def op_calls(shapes, img, pts, wts, og) -> tuple:
    """(library, wrapper call) for K1 and K2 on these inputs."""
    return (("msda_fwd", lambda: cuda_fwd.msda_fwd(img, shapes, pts, wts)),
            ("msda_bwd", lambda: cuda_bwd.msda_bwd(img, shapes, pts, wts,
                                                   og)))


def compare(lib: str, libs: dict, call) -> list:
    """New against old on the same inputs: the largest error of each
    output relative to max(1, |old|)."""
    outs = {}
    for v in ("old", "new"):
        swap(lib, libs[(lib, v)])
        out = call()
        outs[v] = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    return [cs.errors(n, o)[2] for n, o in zip(outs["new"], outs["old"])]


def timed(lib: str, handle, call):
    def fn():
        swap(lib, handle)
        call()
    return fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier msda_fwd.cu, "
                         "msda_bwd.cu, msda_stream.cu and their headers")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "kernel_ab.log"),
                    help="where to write the lines printed")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    libs = build_with_parent(args.parent)
    for case_name, op_case, make, iters in CASES:
        img32, pts, wts, og32 = make()
        shapes = cs.OP_CASES[op_case]["shapes"]
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            for lib, call in op_calls(shapes, img, pts, wts, og):
                errs = compare(lib, libs, call)
                res = in_turns({v: timed(lib, libs[(lib, v)], call)
                                for v in ("old", "new")}, iters,
                               KERNEL_SYMBOL[lib])
                what = f"{lib} {case_name} {str(dtype)[6:]}"
                log_turns(what, res, smi)
                log(f"ab {what} new vs old, err relative to max(1, |old|): "
                    f"{', '.join(f'{e:.2e}' for e in errs)}")
                swap(lib, libs[(lib, "new")])
        del img32, pts, wts, og32

    # the streamed kernels share the lane-group header
    img32, pts, wts, og32 = cs.stream_inputs(cs.BIG_SHAPES, B=4, N=10000,
                                             H=8, C=32, P=4, seed=61)
    for dtype in (torch.float32, torch.bfloat16):
        img, og = img32.to(dtype), og32.to(dtype)
        for name, call in (
                ("msda_stream_fwd", lambda: cuda_stream.msda_stream_fwd(
                    img, cs.BIG_SHAPES, pts, wts)),
                ("msda_stream_bwd", lambda: cuda_stream.msda_stream_bwd(
                    img, cs.BIG_SHAPES, pts, wts, og))):
            res = in_turns({v: timed("msda_stream", libs[("msda_stream", v)],
                                     call) for v in ("old", "new")}, 20,
                           name + "_kernel")
            log_turns(f"{name} big_pyramid {str(dtype)[6:]}", res, smi)
    swap("msda_stream", libs[("msda_stream", "new")])
    log(f"kernel A/B done in {time.perf_counter() - t0:.1f} s")
    write_log(args.out)


if __name__ == "__main__":
    main()
