"""Capture a profiler trace of the MSDA op: the counterpart of
``scripts/capture_trace.py``.

    python -m msda_tpu_torch.capture_trace [--mode fwd|bwd|fwdbwd]
        [--dtype float32] [--queries 10000] [--iters 30] [--impl cuda]
        [--out build/traces/NAME] [--device cuda|cpu]

Runs ``--iters`` calls at ``utils.bench``'s reference workload (B=4, H=8,
C=32, P=4, pyramid 64/32/16/8, ``padding_mode="border"``,
``align_corners=True``) under ``utils.profile.trace``, each call in an
``annotate`` span named after the mode, after two warm-up calls outside the
trace.  ``fwd`` is the op's forward under ``inference_mode``; ``fwdbwd``
the forward and the three input gradients through autograd; ``bwd`` the
backward alone, no forward in the trace: K2 itself (``cuda_bwd.msda_bwd``)
with ``--impl cuda``, its plain version with ``--impl reference``.  It
writes the Chrome trace to ``build/traces/<mode>_<dtype>_<impl>/`` unless
``--out`` says otherwise, and prints the window, the device's busy time
and each device kernel's time.  The default device is the CUDA card, and a
run without one fails; ``--device cpu`` (``--impl reference``) must be
asked for, and traces the host only.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .ops import multiscale_deformable_attention, native_msda_backward
from .utils import profile, reference_workload

PADDING, ALIGN = "border", True
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m msda_tpu_torch.capture_trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=["fwd", "bwd", "fwdbwd"],
                    default="fwd")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--queries", type=int, default=10000)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--impl", choices=["cuda", "reference"], default=None,
                    help="default: cuda on the card, reference on the CPU")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _step(mode, impl, img, shapes, pts, wts, og):
    """One call of ``mode``: a function of no arguments."""
    if mode == "fwd":
        def step():
            with torch.inference_mode():
                multiscale_deformable_attention(img, shapes, pts, wts,
                                                PADDING, ALIGN, impl=impl)
    elif mode == "bwd":
        if impl == "cuda":
            from .ops import cuda_bwd

            backward = cuda_bwd.msda_bwd
        else:
            backward = native_msda_backward

        def step():
            backward(img, shapes, pts, wts, og, PADDING, ALIGN)
    else:
        def step():
            leaves = [t.detach().requires_grad_(True) for t in (img, pts, wts)]
            out = multiscale_deformable_attention(
                leaves[0], shapes, *leaves[1:], PADDING, ALIGN, impl=impl)
            torch.autograd.grad(out, leaves, og)
    return step


def main(argv=None) -> dict:
    """Capture the trace and print it; returns ``{"out", "window_ms",
    "busy_ms", "kernel_ms", "span_ms"}``."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    impl = args.impl or ("cuda" if device.type == "cuda" else "reference")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is visible; pass --device cpu "
                             "--impl reference to trace the host")
        name = torch.cuda.get_device_name(device)
    else:
        if impl == "cuda":
            raise SystemExit("impl 'cuda' needs a CUDA device; use "
                             "--device cpu with --impl reference")
        name = "cpu (host only)"
    out = args.out or os.path.join(
        _ROOT, "build", "traces", f"{args.mode}_{args.dtype}_{impl}")

    img, shapes, pts, wts, og = reference_workload(
        args.queries, getattr(torch, args.dtype), device=device)
    step = _step(args.mode, impl, img, shapes, pts, wts, og)
    for _ in range(2):  # builds the kernels, warms the allocator
        step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"warm OK ({name}, impl={impl}); tracing {args.iters} {args.mode}"
          f" calls at N={args.queries} -> {out}", flush=True)

    with profile.trace(out) as t:
        for _ in range(args.iters):
            with profile.annotate(args.mode):
                step()
    kernels = t.kernel_ms()
    result = {"out": t.path, "window_ms": t.window_ms, "busy_ms": t.busy_ms(),
              "kernel_ms": kernels, "span_ms": t.span_ms()}
    print(f"trace written to {t.path}: window {t.window_ms:.3f} ms, device "
          f"busy {result['busy_ms']:.3f} ms over {args.iters} calls",
          flush=True)
    for kernel, ms in kernels.items():
        print(f"  {ms:10.4f} ms  {ms / args.iters:9.4f} ms a call  {kernel}",
              flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
