"""Three DINO forwards' operations a step (``arith.flops_dino``, at the
mean number of denoising queries of the pool's batches, which the window
cycles through) of every step in the window, over the window, as a share
of the H100's f32 peak outside the tensor cores (TF32 stays off)."""

from perfbench.arith import peaks
from perfbench.arith.flops_dino import dino_forward_flops


def read(run):
    pads = run.state.get("pads") if isinstance(run.state, dict) else None
    if not pads:
        return None
    step = 3 * dino_forward_flops(run.config, run.traffic["batch"],
                                  run.traffic["size"], sum(pads) / len(pads))
    return 100.0 * step * run.units / run.window_s / peaks.F32_FLOPS
