"""The share of the traced slice in which no kernel, copy or memset ran
on the device (``idle_pct.<cells>``: one per kind of cell, as each moves
its cell's own end-to-end metric)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.traced_s)
