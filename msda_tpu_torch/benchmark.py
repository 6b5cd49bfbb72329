"""MSDA op benchmark: the counterpart of ``scripts/benchmark.py``.

    python -m msda_tpu_torch.benchmark [--pyramid ref|big] [--force-stream]
        [--queries N ...] [--impls cuda reference] [--bf16] [--no-memory]
        [--out PATH] [--resume] [--device cuda|cpu]

Sweeps the number of queries at the reference workload (B=4, H=8, C=32,
P=4, ``padding_mode="border"``, ``align_corners=True``;
``utils.reference_workload``) on the reference pyramid 64/32/16/8 or, with
``--pyramid big``, the 256-base pyramid 256/128/64/32 (I = 87,040 pixels,
356 MB of f32 ``img`` at B=4), beyond the card's L2, where
``impl="cuda"`` still runs K1 and K2.  ``--force-stream`` routes every
``cuda`` call to the streamed kernels (``ops.stream.FORCE``).  For each implementation (f32; ``--bf16``
adds ``cuda`` in bf16) and each N it measures:

  fwd_ms       the op's forward, under ``inference_mode``;
  fwdbwd_ms    the forward and the three input gradients (autograd);
  peak_mem_mb  ``torch.cuda.max_memory_allocated`` during one forward and
               backward, less the memory allocated before it (msda-triton's
               metric, not the XLA temp + output bytes of the JAX script).

Times are medians over three runs of CUDA events (``utils.timeit_op``).
The CSV has the JAX script's columns, then ``device`` (the card's name) and
``power_limit`` (its ``nvidia-smi`` power limit; empty on the CPU); it goes
to ``build/benchmark_<pyramid>[_stream]_<device>.csv`` unless ``--out``
says otherwise.  Each row is flushed to ``<out>.partial`` as soon as it is
measured, and the file is renamed to ``<out>`` at the end, so a sweep that
is cut keeps its rows; ``--resume`` skips the (impl, dtype, N) rows already
in ``<out>`` or its ``.partial`` and keeps them in the output.  The default device is the CUDA card, and a run without one
fails: ``--device cpu`` (``reference`` only, with ``--no-memory``) must be
asked for, and its times are the host's.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import sys

import torch

from .ops import multiscale_deformable_attention, stream
from .utils import (card_identity, device_memory_stats, reference_workload,
                    timeit_op)

PYRAMIDS = {
    "ref": ((64, 64), (32, 32), (16, 16), (8, 8)),
    "big": ((256, 256), (128, 128), (64, 64), (32, 32)),
}
PADDING, ALIGN = "border", True
# the JAX script's columns first, then the device that measured the row
FIELDS = ["impl", "dtype", "num_queries", "fwd_ms", "fwdbwd_ms",
          "peak_mem_mb", "device", "power_limit"]
_NUMBERS = ("fwd_ms", "fwdbwd_ms", "peak_mem_mb")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fwd(impl, img, shapes, pts, wts):
    return multiscale_deformable_attention(img, shapes, pts, wts, PADDING,
                                           ALIGN, impl=impl)


def _fwdbwd(impl, img, shapes, pts, wts, og):
    leaves = [t.detach().requires_grad_(True) for t in (img, pts, wts)]
    out = _fwd(impl, leaves[0], shapes, *leaves[1:])
    return torch.autograd.grad(out, leaves, og)


def _iters(impl, n, pyramid):
    """(forward, forward + backward) calls per timed run: fewer for the
    plain version at large N or on the big pyramid, whose calls take tens
    of milliseconds."""
    if impl == "reference" and (n >= 900 or pyramid != "ref"):
        return 5, 3
    return (20, 10) if pyramid != "ref" else (50, 20)


def bench(impl, dtype, n, pyramid, device, memory=True):
    """One CSV row: ``impl`` in ``dtype`` at ``n`` queries."""
    img, shapes, pts, wts, og = reference_workload(
        n, dtype, PYRAMIDS[pyramid], device=device)
    it_f, it_fb = _iters(impl, n, pyramid)

    def fwd():
        with torch.inference_mode():
            _fwd(impl, img, shapes, pts, wts)

    def fwdbwd():
        _fwdbwd(impl, img, shapes, pts, wts, og)

    t_f = timeit_op(fwd, n=it_f, device=device) * 1e3
    t_fb = timeit_op(fwdbwd, n=it_fb, device=device) * 1e3
    mem = float("nan")
    if memory:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = device_memory_stats(device)["bytes_in_use"]
        fwdbwd()
        torch.cuda.synchronize(device)
        mem = (device_memory_stats(device)["peak_bytes_in_use"]
               - before) / 1e6
    return dict(impl=impl, dtype=str(dtype).removeprefix("torch."),
                num_queries=n, fwd_ms=round(t_f, 4),
                fwdbwd_ms=round(t_fb, 4), peak_mem_mb=round(mem, 1))


def measured_rows(out: str) -> dict:
    """The rows an earlier run of this sweep left in ``out`` or in
    ``out + ".partial"``, by ``(impl, dtype, num_queries)``; the numbers
    parsed.  A row that a cut run left incomplete is skipped."""
    done = {}
    for path in (out, out + ".partial"):
        if not os.path.exists(path):
            continue
        with open(path, newline="") as f:
            for raw in csv.DictReader(f):
                try:
                    row = dict(raw, num_queries=int(raw["num_queries"]),
                               **{k: float(raw[k]) for k in _NUMBERS})
                except (KeyError, TypeError, ValueError):
                    continue
                if not (math.isfinite(row["fwd_ms"])
                        and math.isfinite(row["fwdbwd_ms"])):
                    continue
                done.setdefault(
                    (row["impl"], row["dtype"], row["num_queries"]), row)
    return done


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m msda_tpu_torch.benchmark", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pyramid", choices=list(PYRAMIDS), default="ref")
    ap.add_argument("--force-stream", action="store_true",
                    help="route every impl='cuda' call to the streamed "
                         "kernels")
    ap.add_argument("--queries", nargs="+", type=int,
                    default=[10, 100, 300, 900, 1000, 10000])
    ap.add_argument("--impls", nargs="+", choices=["cuda", "reference"],
                    default=["cuda", "reference"])
    ap.add_argument("--bf16", action="store_true",
                    help="also run impl='cuda' in bfloat16")
    ap.add_argument("--no-memory", action="store_true",
                    help="skip the peak-memory column (NaN)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="skip the (impl, dtype, N) rows already in --out "
                         "or its .partial, and keep them in the output")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> list[dict]:
    """Run the sweep; print and write the rows, and return them."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    configs = [(impl, torch.float32) for impl in args.impls]
    if args.bf16:
        configs.append(("cuda", torch.bfloat16))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is visible; pass --device cpu "
                             "to time impl='reference' on the host")
        name, limit = card_identity(device)
        name = name or torch.cuda.get_device_name(device)
        card = {"device": name, "power_limit": limit}
    else:
        if any(impl == "cuda" for impl, _ in configs):
            raise SystemExit("impl 'cuda' needs a CUDA device; use "
                             "--device cpu with --impls reference only")
        if not args.no_memory:
            raise SystemExit("peak memory is measured on a CUDA device "
                             "only; pass --no-memory with --device cpu")
        name = "cpu (host clock)"
        card = {"device": "cpu", "power_limit": ""}
    if args.out is None:
        suffix = "_stream" if args.force_stream else ""
        args.out = os.path.join(
            _ROOT, "build",
            f"benchmark_{args.pyramid}{suffix}_{device.type}.csv")
    print(f"device: {name}; pyramid {args.pyramid} "
          f"{PYRAMIDS[args.pyramid]}; force_stream {args.force_stream}",
          flush=True)

    done = measured_rows(args.out) if args.resume else {}
    if done:
        print(f"resume: {len(done)} rows already measured", flush=True)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    partial = args.out + ".partial"
    rows = []
    # each row is flushed as it is measured, so that a cut sweep leaves a
    # CSV of its rows; the complete file replaces ``out`` at the end
    with open(partial, "w", newline="") as f, stream.forced(
            args.force_stream or stream.FORCE):
        writer = csv.DictWriter(f, fieldnames=FIELDS, restval="",
                                extrasaction="ignore")
        writer.writeheader()
        f.flush()
        for impl, dtype in configs:
            for n in args.queries:
                key = (impl, str(dtype).removeprefix("torch."), n)
                if key in done:
                    row, tag = done[key], "resumed"
                else:
                    row = dict(bench(impl, dtype, n, args.pyramid, device,
                                     memory=not args.no_memory), **card)
                    tag = "measured"
                writer.writerow(row)
                f.flush()
                rows.append(row)
                print(f"{row['impl']:10s} {row['dtype']:8s} N={n:6d}: fwd "
                      f"{row['fwd_ms']:10.4f} ms, fwd+bwd "
                      f"{row['fwdbwd_ms']:10.4f} ms, mem "
                      f"{row['peak_mem_mb']:8.1f} MB ({tag})", flush=True)
    os.replace(partial, args.out)
    print(f"wrote {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
