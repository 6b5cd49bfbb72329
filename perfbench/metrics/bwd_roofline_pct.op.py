"""The backward's least time (``arith.bound.msda_bound`` of each traced
call's inputs, ``img`` in the rows its points reach, ``img_grad`` whole)
over the device time of every kernel, copy or memset launched inside the
backward's span (``perfbench.bwd``), whatever its name."""

from perfbench.arith.roofline import op_roofline_pct


def read(run):
    return op_roofline_pct(run, backward=True)
