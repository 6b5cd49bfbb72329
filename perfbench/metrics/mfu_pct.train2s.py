"""Three forwards' operations a step (``arith.flops_two_stage``: the
detector's and the published proposal stage's) of every step in the
window, over the window, as a share of the H100's f32 peak outside the
tensor cores (TF32 stays off)."""

from perfbench.arith import peaks
from perfbench.arith.flops_two_stage import two_stage_forward_flops


def read(run):
    step = 3 * two_stage_forward_flops(run.config, run.traffic["batch"],
                                       run.traffic["size"])
    return 100.0 * step * run.units / run.window_s / peaks.F32_FLOPS
