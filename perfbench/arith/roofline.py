"""A traced op call's share of its roofline: the least time of the calls
in the traced slice (``bound.msda_bound`` of each call's own inputs, img
counted in the rows its points reach) over the device time of the work
launched inside the harness's span around that direction."""

from __future__ import annotations

from .bound import msda_bound, touched_rows

SPANS = {False: "perfbench.fwd", True: "perfbench.bwd"}


def op_roofline_pct(run, backward: bool):
    if run.trace is None:
        return None
    device_s = run.trace.span_device_s(set(SPANS.values())).get(
        SPANS[backward], 0.0)
    if not device_s:
        return None
    cfg, pool = run.config, run.state["pool"]
    bound = {}
    for k, x in enumerate(pool):
        B, N, H, L, P, _ = x["pts"].shape
        rows = touched_rows(x["shapes"], x["pts"].detach(),
                            x["wts"].detach(), cfg["padding_mode"],
                            cfg["align_corners"])
        bound[k] = msda_bound(x["shapes"], B, N, H, cfg["head_dim"], P,
                              item=x["img"].element_size(),
                              backward=backward, img_rows=rows)["ms"]
    calls = run.trace.span_count(SPANS[backward])
    if calls != len(run.traced):
        return None
    least_s = sum(bound[i % len(pool)] for i in run.traced) / 1e3
    return 100.0 * least_s / device_s
