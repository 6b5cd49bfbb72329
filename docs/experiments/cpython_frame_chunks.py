#!/usr/bin/env python3
"""CPython's frame-stack chunks and a function with a very large frame, on
the host's CPU alone.

    python3 docs/experiments/cpython_frame_chunks.py [--pad-to SLOTS]

CPython (3.11 on) keeps a thread's frames in chunks of 16 KiB.  A frame
that fits in the current chunk but leaves less room than the frame of a
function it calls makes each such call allocate a new chunk and free it
on return.  An exported program's generated ``forward`` (one local for
each graph node) is such a function; ``utils.export.load_exported`` pads
its frame past a chunk (``PERF.md`` §6).

This script builds functions ``big(x)`` of ``n`` statements ``v_i =
f(x)`` (``n`` locals, ``f`` a one-line Python function), for every ``n``
from 50 to 2,100, and calls each at caller depths 0 to 3.  It prints the
worst cost of one call of ``f`` (and of that call of ``big``) with the
locals as they are and with the frame padded to ``--pad-to`` slots
(default 2,100) by dead locals, as ``load_exported`` pads it, and how
many (n, depth) pairs with n >= 200 cost more than 0.5 us a call of
``f``.  Host time only: no device is involved; ~1 min.
"""

from __future__ import annotations

import argparse
import time


def f(x):
    return x


def make(n: int, pad: int):
    """``big(x)`` with ``n`` calls of ``f``, each to a local of its own,
    and ``pad`` dead locals."""
    lines = ["def big(x):"]
    if pad > 0:
        lines.append("    if False: " + " = ".join(
            f"_frame_pad_{i}" for i in range(pad)) + " = None")
    lines += [f"    v{i} = f(x)" for i in range(n)] + ["    return x"]
    scope = {"f": f}
    exec("\n".join(lines), scope)
    return scope["big"]


def at_depth(depth: int, fn) -> float:
    """Seconds of one call of ``fn``, made ``depth`` frames deeper."""
    if depth == 0:
        t0 = time.perf_counter()
        fn(1)
        return time.perf_counter() - t0
    return at_depth(depth - 1, fn)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pad-to", type=int, default=2100)
    args = ap.parse_args(argv)
    for pad_to in (0, args.pad_to):
        costs = []
        for n in range(50, 2101):
            fn = make(n, pad_to - n if pad_to else 0)
            fn(1)
            for depth in range(4):
                s = min(at_depth(depth, fn) for _ in range(2))
                costs.append((s * 1e6 / n, n, depth))
        costs.sort(reverse=True)
        worst, n, depth = costs[0]
        # past n = 200 a padded big()'s one chunk a call adds < 0.2 us to
        # each call of f
        slow = sum(1 for c in costs if c[0] > 0.5 and c[1] >= 200)
        print(f"frame padded to {pad_to or 'none'}: worst {worst:.3f} us a "
              f"call of f, {worst * n:.1f} us the call of big (n={n}, "
              f"depth {depth}); {slow} (n >= 200, depth) pairs above 0.5 us "
              f"a call of f; median {costs[len(costs) // 2][0]:.3f} us",
              flush=True)


if __name__ == "__main__":
    main()
