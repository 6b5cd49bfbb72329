"""The op's headline lines: the counterpart of root ``bench.py``.

    python -m msda_tpu_torch.headline [--device cuda|cpu]

Prints root ``bench.py``'s three JSON lines, in its order, at its workload
(``utils.reference_workload(num_queries=10000)``: B=4, H=8, C=32, P=4,
pyramid 64/32/16/8, seed 0; ``padding_mode="border"``,
``align_corners=True``), one line each, flushed as soon as it is measured:

    {"metric": "MSDA fwd+bwd latency @10k queries fp32 (cuda)",
     "value": ms, "unit": "ms", "vs_baseline": 22.78 / ms}
    {"metric": "MSDA fwd+bwd latency @10k queries bf16 (cuda)", ...}  22.78
    {"metric": "MSDA fwd latency @10k queries fp32 (cuda)", ...}      3.78

The anchors are msda-triton's published times on an RTX 2060 (f32, 10k
queries; the bf16 line reuses the f32 anchor, as ``bench.py`` does).
``value`` is the median over 3 runs of 150 calls after a warm-up, timed
with CUDA events (``utils.timeit_op``); the fwd+bwd lines time the op's
forward and its three input gradients (``benchmark``'s fwd+bwd), the fwd
line the forward under ``inference_mode``.  The default device is the CUDA
card, with ``impl="cuda"``.  ``--device cpu`` must be asked for: it runs
``bench.py``'s branch without the accelerator, ``impl="reference"``, the
f32 fwd+bwd line only, 15 calls x 2 runs, on the host's clock.

Exit status: 0 when every expected line was printed with a finite value.
Without a card (and without ``--device cpu``) it prints one line with an
``"error"`` key and exits 2; it never falls back to the CPU.  A line whose
measurement fails is printed with ``"value": null`` and an ``"error"``,
and the run exits 1.  Standard error gets, at the end, every kernel's
launch count in this process (``launches {...}``: K1, K2 and the three
streamed kernels).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from .benchmark import _fwd, _fwdbwd
from .utils import reference_workload, timeit_op

__all__ = ["CONFIGS", "NUM_QUERIES", "measure", "main"]

NUM_QUERIES = 10000
# (metric, dtype, mode, anchor ms): bench.py's configs, in its order
CONFIGS = (
    ("MSDA fwd+bwd latency @10k queries fp32", torch.float32, "fwdbwd",
     22.78),
    ("MSDA fwd+bwd latency @10k queries bf16", torch.bfloat16, "fwdbwd",
     22.78),
    ("MSDA fwd latency @10k queries fp32", torch.float32, "fwd", 3.78),
)
# (calls a run, runs): bench.py's, on the card and on the host
ITERS = {"cuda": (150, 3), "cpu": (15, 2)}


def measure(dtype, mode: str, impl: str, device, iters: int, repeats: int,
            num_queries: int = NUM_QUERIES, shapes=None) -> float:
    """Median ms a call of the op (``mode`` "fwd" or "fwdbwd") at the
    reference workload in ``dtype`` on ``device``."""
    img, shapes, pts, wts, og = reference_workload(
        num_queries, dtype, shapes, device=device)
    if mode == "fwdbwd":
        def step():
            _fwdbwd(impl, img, shapes, pts, wts, og)
    else:
        def step():
            with torch.inference_mode():
                _fwd(impl, img, shapes, pts, wts)
    return timeit_op(step, n=iters, repeats=repeats, device=device) * 1e3


def _launches() -> dict:
    """Every kernel of the op's launch count in this process (importing a
    wrapper builds nothing)."""
    from .ops import cuda_bwd, cuda_fwd, cuda_stream, launches
    return launches.counts(cuda_fwd, cuda_bwd, cuda_stream)


def _line(metric: str, ms, anchor: float, error: str | None = None) -> dict:
    ok = ms is not None and math.isfinite(ms) and ms > 0
    line = {"metric": metric, "value": round(ms, 3) if ok else None,
            "unit": "ms",
            "vs_baseline": round(anchor / ms, 4) if ok else None}
    if error is not None:
        line["error"] = error
    elif not ok:
        line["error"] = f"not a finite time: {ms!r}"
    return line


def main(argv=None, *, num_queries: int = NUM_QUERIES, shapes=None,
         iters: int | None = None, repeats: int | None = None) -> int:
    """Measure and print the lines; return the exit status.  The keyword
    arguments shrink the workload and the runs (tests); the command line
    has none of them."""
    ap = argparse.ArgumentParser(
        prog="python -m msda_tpu_torch.headline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print(json.dumps(_line(
                f"{CONFIGS[0][0]} (cuda)", None, CONFIGS[0][3],
                "no CUDA device is visible; pass --device cpu to time "
                "impl='reference' on the host")), flush=True)
            return 2
        impl, configs = "cuda", CONFIGS
    else:
        impl, configs = "reference", CONFIGS[:1]
    default_iters, default_repeats = ITERS[device.type]
    iters, repeats = iters or default_iters, repeats or default_repeats
    status = 0
    for name, dtype, mode, anchor in configs:
        metric = f"{name} ({impl})"
        try:
            ms = measure(dtype, mode, impl, device, iters, repeats,
                         num_queries, shapes)
            line = _line(metric, ms, anchor)
        except Exception as exc:  # noqa: BLE001 - reported on the line
            line = _line(metric, None, anchor,
                         f"{type(exc).__name__}: {exc}")
        if line["value"] is None:
            status = 1
        print(json.dumps(line), flush=True)
    print(f"launches {json.dumps(_launches())}", file=sys.stderr,
          flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
