#!/usr/bin/env python3
"""A/B timing of the port's K1 / K2 / streamed kernels against an earlier
version of their sources, on one NVIDIA GPU.

    git archive <commit> msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_kernel_ab.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

K1 and K2 of the earlier sources are built with ``nvcc`` next to the
current ones (``msda_tpu_torch/csrc``) and swapped in through
``_build._LOADED``, so both run behind the same Python wrappers (their C
entry points keep their signatures).  The streamed kernels' entry points
changed with their redesign, so the earlier ones run behind the earlier
wrappers: the ``ops`` package beside ``--parent`` (and beside each
``--also TAG=CSRC``), imported under another name (``parent_module``),
which builds its own sources into its own ``build/`` and plans its own
tiles.  K1 and K2 are timed at Deformable DETR's encoder and decoder
shapes and the reference workload (``chip_smoke.py``'s ``OP_CASES``) in
f32 and bf16, on uniform points (``chip_smoke.op_inputs``) and on the
points of the first encoder and decoder layers of ``chip_smoke.py``'s
full-width model (``model_inputs``); ``--streamed-only`` skips them, and
``--resident-only`` skips the streamed kernels.  The streamed kernels
are timed at the 256- and 512-base pyramids (uniform points, B=4) and at
encoder layer 0's call of the full-width model at 1600x2666 (batch 2),
2560x4266 and 3200x5332 (batch 1), the model's own points, beside K1 / K2
on the same inputs (``resident``).  Each kernel is timed in turns (old,
..., new, new, ..., old), two ways:

  * ``events``: CUDA events around the wrapper's calls, so the time holds
    whatever the host adds where it cannot keep the card busy;
  * ``device``: ``torch.profiler``'s device time of the kernel alone, and
    of every device operation of the call (the binning, K2's ``img_grad``
    memset and casts included), per call; for the streamed cases also
    each device kernel's share of the call.

The new kernels are checked against the old ones on the same inputs, the
streamed ones within ``chip_smoke.py``'s tolerances (phase 7a).
Prints one line per timing with the card's ``nvidia-smi`` name and power
limit, and writes them to ``--out`` (default ``build/kernel_ab/
kernel_ab.log``).  Needs a CUDA card and ``nvcc``; exits non-zero without
them.  ``torch_kernel_variants.py`` uses its building and timing to time
text-substituted variants of the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
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
    ``include[(library, variant)]`` is the directory of its headers, or a
    list of them, searched in order."""
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for (lib, variant), text in jobs.items():
        cu = os.path.join(OUT_DIR, f"{lib}_{variant}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT_DIR, f"lib{lib}_{variant}.so")
        dirs = include[(lib, variant)]
        dirs = [dirs] if isinstance(dirs, str) else dirs
        cmd = [nvcc, *_build.NVCC_FLAGS, *(f"-I{d}" for d in dirs),
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
    """The parent's K1 and K2 libraries as ``(lib, "old")``, the checkout's
    three as ``(lib, "new")`` and ``extra`` sources besides."""
    jobs, include = dict(extra or {}), dict(extra_include or {})
    for lib in ("msda_fwd", "msda_bwd"):
        with open(os.path.join(parent, lib + ".cu")) as f:
            jobs[(lib, "old")] = f.read()
        include[(lib, "old")] = parent
    libs = build(jobs, include)
    for lib in ("msda_fwd", "msda_bwd", "msda_stream"):
        libs[(lib, "new")] = _build.load_library(lib)
    return libs


def parent_module(parent: str, name: str, tag: str = "parent"):
    """Module ``name`` of the ``ops`` package beside the earlier ``csrc``
    ``parent``, imported as ``_<tag>_ops.<name>``: the earlier wrappers,
    band plan and build, apart from the checkout's."""
    ops = os.path.join(os.path.dirname(os.path.abspath(parent)), "ops")
    package = f"_{tag}_ops"
    if package not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            package, os.path.join(ops, "__init__.py"),
            submodule_search_locations=[ops])
        module = importlib.util.module_from_spec(spec)
        sys.modules[package] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"{package}.{name}")


def swap(lib: str, handle, module=cuda_stream) -> None:
    """Put ``handle`` behind the wrappers of ``lib``; for msda_stream,
    behind ``module``'s (the checkout's cuda_stream or the parent's)."""
    if lib == "msda_stream":
        module._build._LOADED[lib] = handle
        module.load()
    else:
        _build._LOADED[lib] = handle


def device_ms(fn, iters: int, symbol: str | None,
              parts: dict | None = None) -> tuple[float, float]:
    """(kernel, whole call) device ms per call of ``fn`` under
    ``torch.profiler``: the summed device time of the events whose name
    holds ``symbol``, and of every device event; NaN where the profiler saw
    none.  ``parts``, where given, gets the device ms per call of each
    event name."""
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
        if parts is not None:
            found = re.search(r"\w*kernel\w*", e.name)
            name = (found.group(0) if found else e.name)[:40]
            parts[name] = parts.get(name, 0.0) + us / iters / 1e3
    nan = float("nan")
    return ((kernel / iters / 1e3 if kernel else nan),
            (total / iters / 1e3 if total else nan))


def in_turns(fns: dict, iters: int, symbol: str | None = None,
             parts: dict | None = None) -> dict:
    """{name: fn} -> {name: {"events": (mean, first, second),
    "kernel": (...), "call": (...)}} in ms, timed a b ... b a.  ``parts``,
    where given, gets {name: {event name: device ms per call}} of the
    second turn."""
    names = list(fns)
    runs = {n: [] for n in names}
    for i, n in enumerate(names + names[::-1]):
        part = None
        if parts is not None and i >= len(names):
            part = parts.setdefault(n, {})
        runs[n].append((cs.time_ms(fns[n], iters),
                        *device_ms(fns[n], iters, symbol, part)))
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


def model_inputs(call: int, hw=cs.IMAGE_HW, batch: int = cs.BATCH):
    """The arguments of the op's ``call``-th call in one forward of
    ``chip_smoke.py``'s full-width two-stage model at an input of ``hw``
    pixels (0: encoder layer 0, 6: decoder layer 0; ``cs.model_call``), and
    a seeded normal out_grad: the sampling pattern of the main path."""
    img, _, pts, wts = cs.model_call(hw, batch, call)
    rng = np.random.default_rng(8)
    og = torch.from_numpy(rng.standard_normal(
        tuple(img.shape[:1]) + tuple(pts.shape[1:3]) + tuple(img.shape[3:]),
        dtype=np.float32)).to(cs.DEVICE)
    return [img, pts, wts, og]


# name, OP_CASES entry, inputs, launches per timing
CASES = (
    ("encoder", "encoder",
     lambda: cs.op_inputs(**cs.OP_CASES["encoder"], out_grad=True), 20),
    ("encoder_model", "encoder", lambda: model_inputs(0), 20),
    ("decoder", "decoder",
     lambda: cs.op_inputs(**cs.OP_CASES["decoder"], out_grad=True), 200),
    ("decoder_model", "decoder", lambda: model_inputs(6), 200),
    ("reference_workload", "reference_workload",
     lambda: cs.op_inputs(**cs.OP_CASES["reference_workload"],
                          out_grad=True), 20),
)


def op_calls(shapes, img, pts, wts, og) -> tuple:
    """(library, wrapper call) for K1 and K2 on these inputs."""
    return (("msda_fwd", lambda: cuda_fwd.msda_fwd(img, shapes, pts, wts)),
            ("msda_bwd", lambda: cuda_bwd.msda_bwd(img, shapes, pts, wts,
                                                   og)))


# the streamed kernels' cases: name, pyramid, inputs.  At 2560x4266 and
# 3200x5332 (batch 1) one image's f32 pyramid and gradient take 465 and
# 726 MB, 9 and 14 times an H100's L2 (the 512-base pyramid: 713 MB).
BIG_MODEL_SIZES = ((2560, 4266), (3200, 5332))
STREAM_CASES = (
    ("big_pyramid", cs.BIG_SHAPES,
     lambda: cs.stream_inputs(cs.BIG_SHAPES, B=4, N=10000, H=8, C=32, P=4,
                              seed=61)),
    ("base_512", cs.PATH_SHAPES,
     lambda: cs.stream_inputs(cs.PATH_SHAPES, B=4, N=10000, H=8, C=32, P=4,
                              seed=63)),
    ("model_1600x2666", cs.model_shapes(cs.MODEL_SIZES[-1]),
     lambda: model_inputs(0, cs.MODEL_SIZES[-1])),
    *((f"model_{hw[0]}x{hw[1]}_b1", cs.model_shapes(hw),
       lambda hw=hw: model_inputs(0, hw, batch=1))
      for hw in BIG_MODEL_SIZES),
)


def stream_ab(parent: str, smi: str, also: dict, iters: int = 30) -> None:
    """The streamed kernels, the parent's (``old``) and any other earlier
    version (``also``: {tag: csrc}) behind their own wrappers against the
    checkout's (``new``), with K1 / K2 (``resident``) on the same inputs,
    in turns; each whole call's device time by kernel; new against each
    earlier version on the same inputs."""
    versions = {"old": parent_module(parent, "cuda_stream")}
    for tag, csrc in also.items():
        versions[tag] = parent_module(csrc, "cuda_stream", tag)
    versions["new"] = cuda_stream
    for case, shapes, make in STREAM_CASES:
        img32, pts, wts, og32 = make()
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            for name, tols, resident in (
                    ("msda_stream_fwd", (cs.TOL[dtype],), cuda_fwd.msda_fwd),
                    ("msda_stream_bwd", (cs.IMG_GRAD_TOL[dtype],
                                         cs.POINT_GRAD_TOL,
                                         cs.POINT_GRAD_TOL),
                     cuda_bwd.msda_bwd)):
                args = ((img, shapes, pts, wts) if name.endswith("fwd")
                        else (img, shapes, pts, wts, og))
                fns = {v: (lambda m=m: getattr(m, name)(*args))
                       for v, m in versions.items()}
                outs = {v: fn() for v, fn in fns.items()}
                outs = {v: o if isinstance(o, tuple) else (o,)
                        for v, o in outs.items()}
                errs = {v: [cs.errors(n, o)[2]
                            for n, o in zip(outs["new"], outs[v])]
                        for v in versions if v != "new"}
                del outs
                fns["resident"] = lambda: resident(*args)
                what = f"{name} {case} {str(dtype)[6:]}"
                parts = {}
                log_turns(what, in_turns(fns, iters, name + "_kernel",
                                         parts), smi)
                for v, part in parts.items():
                    log(f"ab {what} {v} device ms by kernel: " + "; ".join(
                        f"{k} {ms:.4f}" for k, ms in sorted(
                            part.items(), key=lambda kv: -kv[1])))
                for v, e in errs.items():
                    ok = all(x <= t for x, t in zip(e, tols))
                    log(f"ab {what} new vs {v}, err relative to max(1, "
                        f"|{v}|): {', '.join(f'{x:.2e}' for x in e)} (tol "
                        f"{', '.join(f'{t:g}' for t in tols)}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"new and {v} disagree: {what}")
            del img, og
        del img32, pts, wts, og32


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


def timed(lib: str, handle, call, module=cuda_stream):
    def fn():
        swap(lib, handle, module)
        call()
    return fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier msda_fwd.cu, "
                         "msda_bwd.cu, msda_stream.cu and their headers")
    ap.add_argument("--also", action="append", default=[],
                    metavar="TAG=CSRC",
                    help="another earlier csrc (with its ops beside it) "
                         "whose streamed kernels are timed too")
    ap.add_argument("--streamed-only", action="store_true",
                    help="skip K1 and K2's A/B at the DETR shapes")
    ap.add_argument("--resident-only", action="store_true",
                    help="skip the streamed kernels' A/B")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "kernel_ab.log"),
                    help="where to write the lines printed")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    libs = build_with_parent(args.parent)
    for case_name, op_case, make, iters in (
            () if args.streamed_only else CASES):
        img32, pts, wts, og32 = make()
        shapes = cs.OP_CASES[op_case]["shapes"]
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            for lib, call in op_calls(shapes, img, pts, wts, og):
                errs = compare(lib, libs, call)
                parts = {}
                res = in_turns({v: timed(lib, libs[(lib, v)], call)
                                for v in ("old", "new")}, iters,
                               KERNEL_SYMBOL[lib], parts)
                what = f"{lib} {case_name} {str(dtype)[6:]}"
                log_turns(what, res, smi)
                for v, part in parts.items():
                    log(f"ab {what} {v} device ms by kernel: " + "; ".join(
                        f"{k} {ms:.4f}" for k, ms in sorted(
                            part.items(), key=lambda kv: -kv[1])))
                log(f"ab {what} new vs old, err relative to max(1, |old|): "
                    f"{', '.join(f'{e:.2e}' for e in errs)}")
                swap(lib, libs[(lib, "new")])
        del img32, pts, wts, og32

    if not args.resident_only:
        stream_ab(args.parent, smi,
                  dict(a.split("=", 1) for a in args.also))
    log(f"kernel A/B done in {time.perf_counter() - t0:.1f} s")
    write_log(args.out)


if __name__ == "__main__":
    main()
