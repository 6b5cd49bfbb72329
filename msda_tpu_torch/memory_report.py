"""Device-memory attribution of one MSDA forward (+ backward): the
counterpart of ``scripts/memory_report.py``.

    python -m msda_tpu_torch.memory_report [--impl cuda] [--queries 10000]
        [--dtype float32] [--pyramid ref|big] [--top 15] [--fwd-only]

The JAX tool reconstructs buffer liveness from XLA's scheduled HLO; a
PyTorch program has no such plan, so this one records the CUDA caching
allocator's history instead (``torch.cuda.memory._record_memory_history``,
then ``_snapshot()``) around one call at ``utils.bench``'s reference
workload (``padding_mode="border"``, ``align_corners=True``; the 256-base
pyramid with ``--pyramid big``), after a warm-up call.  From the alloc and
free events of the device trace, :func:`liveness_report` sweeps the bytes
live over time, finds the peak, and lists the blocks live there with
their size and the Python frame that allocated them.  Beside it the tool
prints ``torch.cuda.max_memory_allocated``'s increase over the call, the
peak metric of ``benchmark.py``; the two agree unless the allocator
rounds block sizes.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import torch

__all__ = ["liveness_report", "allocating_frame", "main"]

PYRAMIDS = {
    "ref": ((64, 64), (32, 32), (16, 16), (8, 8)),
    "big": ((256, 256), (128, 128), (64, 64), (32, 32)),
}
PADDING, ALIGN = "border", True
# a free of the allocator's trace: the block is back in the pool
_FREE = "free_completed"


def allocating_frame(frames) -> str:
    """``file:line:function`` of the innermost Python frame outside
    PyTorch's own package (the innermost frame when all are inside it; "?"
    without frames)."""
    if not frames:
        return "?"
    own = [f for f in frames if f.get("filename", "??") != "??"
           and "/torch/" not in f.get("filename", "").replace("\\", "/")]
    f = (own or frames)[0]
    return f"{f.get('filename', '?')}:{f.get('line', '?')}:{f.get('name', '?')}"


def liveness_report(events, top: int = 15):
    """Sweep an allocator trace for its peak.

    ``events`` are the entries of one device's trace in
    ``torch.cuda.memory._snapshot()["device_traces"]``: dicts with
    ``action``, ``addr``, ``size`` and ``frames``.  An ``alloc`` adds its
    block, a ``free_completed`` removes the block at its address; other
    actions (segment maps, free requests, snapshots) change nothing.  A
    free of a block allocated before the trace began lowers the level, and
    the level is counted from 0 at the trace's start, so the peak is the
    largest increase over the start.

    Returns ``(peak_bytes, peak_index, residents)``: the peak, the index of
    the event that reached it, and the blocks live there as ``(bytes,
    frame, addr)``, largest first, at most ``top``.  Raises ``ValueError``
    when the trace holds no allocation.
    """
    if not any(e.get("action") == "alloc" for e in events):
        raise ValueError("the allocator trace holds no alloc event: was "
                         "the history recorded around the call?")
    level = peak = 0
    peak_index = -1
    for i, e in enumerate(events):
        if e.get("action") == "alloc":
            level += e["size"]
            if level > peak:
                peak, peak_index = level, i
        elif e.get("action") == _FREE:
            level -= e["size"]
    live = {}  # addr -> the alloc event of the block there
    for e in events[:peak_index + 1]:
        if e.get("action") == "alloc":
            live[e["addr"]] = e
        elif e.get("action") == _FREE:
            live.pop(e["addr"], None)
    residents = sorted(((e["size"], allocating_frame(e.get("frames")),
                         e["addr"]) for e in live.values()),
                       key=lambda b: (-b[0], b[2]))
    return peak, peak_index, residents[:top]


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m msda_tpu_torch.memory_report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--impl", choices=["cuda", "reference"], default="cuda")
    ap.add_argument("--queries", type=int, default=10000)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--pyramid", choices=list(PYRAMIDS), default="ref")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fwd-only", action="store_true")
    return ap


def main(argv=None) -> dict:
    """Record one call and print the report; returns ``{"allocated_mb",
    "trace_peak_mb", "residents"}`` (``residents`` as
    :func:`liveness_report` gives them)."""
    args = _parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("memory_report reads the CUDA caching allocator; "
                         "no CUDA device is visible")
    from .ops import multiscale_deformable_attention
    from .utils import reference_workload

    device = torch.device("cuda", torch.cuda.current_device())
    img, shapes, pts, wts, og = reference_workload(
        args.queries, getattr(torch, args.dtype), PYRAMIDS[args.pyramid],
        device=device)

    def call():
        if args.fwd_only:
            with torch.inference_mode():
                return multiscale_deformable_attention(
                    img, shapes, pts, wts, PADDING, ALIGN, impl=args.impl)
        leaves = [t.detach().requires_grad_(True) for t in (img, pts, wts)]
        out = multiscale_deformable_attention(
            leaves[0], shapes, *leaves[1:], PADDING, ALIGN, impl=args.impl)
        return out, torch.autograd.grad(out, leaves, og)

    call()  # builds the kernels, warms the allocator
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.memory._record_memory_history(stacks="python",
                                             max_entries=1_000_000)
    try:
        result = call()
        torch.cuda.synchronize(device)
        snapshot = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    allocated = torch.cuda.max_memory_allocated(device) - before
    del result
    events = snapshot["device_traces"][device.index]
    peak, peak_index, residents = liveness_report(events, args.top)

    print(f"config: impl={args.impl} N={args.queries} dtype={args.dtype} "
          f"pyramid={args.pyramid} {'fwd' if args.fwd_only else 'fwd+bwd'} "
          f"on {torch.cuda.get_device_name(device)}")
    print(f"max_memory_allocated increase: {allocated / 1e6:.1f} MB "
          "(benchmark.py's peak_mem_mb)")
    print(f"allocator trace: {len(events)} events, peak {peak / 1e6:.1f} MB "
          f"at event #{peak_index}; blocks live there:")
    for size, frame, _ in residents:
        print(f"  {size / 1e6:9.1f} MB  {frame}")
    return {"allocated_mb": allocated / 1e6, "trace_peak_mb": peak / 1e6,
            "residents": residents}


if __name__ == "__main__":
    main(sys.argv[1:])
