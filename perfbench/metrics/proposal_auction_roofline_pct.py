"""The auction's large-N path as a share of its roofline
(``proposal_auction_roofline_pct.train``): its bound
(``arith.auction_bound``, the cost read once) over the device time of its
four kernels, ``msda_auction_transpose_kernel``, ``_select_``,
``_compact_`` and the ``msda_auction_kernel`` launched inside the
``proposal_loss`` span (the decoder's own auctions lie outside it), a mean
over the traced steps; None unless each traced step holds one such span
(up to a tenth lost, as ``spans.device_ms`` allows)."""

import re

from perfbench import inputs, spans
from perfbench.arith.auction_bound import large_auction_bound_s

KERNEL = re.compile(r"msda_auction_\w*kernel")


def read(run):
    units = len(run.traced)
    if run.trace is None or not units:
        return None
    windows = [(a, b) for name, a, b in spans.marker_windows(run.trace.device)
               if name == "proposal_loss"]
    if not windows or not units - max(1, units // 10) <= len(windows) <= units:
        return None
    busy = spans._union((e["ts"], e["ts"] + e["dur"])
                        for e in run.trace.device if KERNEL.search(e["name"]))
    device_s = sum(spans._overlap(busy, a, b) for a, b in windows) / 1e6
    if not device_s:
        return None
    cfg, tr = run.config, run.traffic
    N = sum(h * w for h, w in inputs.level_shapes(cfg, tr["size"]))
    bound_s = large_auction_bound_s(tr["batch"], N, tr["target_slots"])
    return 100.0 * bound_s * len(windows) / device_s
