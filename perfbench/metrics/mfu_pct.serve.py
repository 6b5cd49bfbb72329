"""The forward's operations of every request in the window (from the
configuration's shapes at each request's size, ``arith.flops``) over the
window, as a share of the H100's dense bf16 peak."""

from perfbench.arith import peaks
from perfbench.arith.flops import detector_forward_flops


def read(run):
    sizes = run.state["sizes"]
    B = run.traffic["batch"]
    per_size = {s: detector_forward_flops(run.config, B, hw)
                for s, hw in enumerate(sizes)}
    flops = sum(per_size[s] for s, _ in run.state["requests"])
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS
