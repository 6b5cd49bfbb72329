"""Computations that more than one metric reads (``metrics/``): each
metric's file names one of these as its ``read``."""

from __future__ import annotations


def images_per_s(run):
    """Images of every unit completed in the window, over the window (the
    window ends with the device drained, so it holds whole units)."""
    return run.units * run.traffic["batch"] / run.window_s


def unit_host_ms(run):
    """Mean host ms of a unit (a call or a step) over the traced slice,
    outside the CUDA API calls it makes (those block while the device's
    queue is full, since the window's units run back to back)."""
    if run.trace is None:
        return None
    ms = run.trace.host_outside_api_s("perfbench.unit")
    return sum(ms) / len(ms) * 1e3 if ms else None
