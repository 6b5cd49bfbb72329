#!/usr/bin/env python3
"""Break the lane-group K1 of commit cc78811 down, on one NVIDIA GPU: the
measurement behind K1's redesign (``msda_tpu_torch/csrc/msda_fwd.cu``).

    git archive cc78811 msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_fwd_breakdown.py \
        --parent build/ab_parent/msda_tpu_torch/csrc [--ncu]

Variants of that ``msda_fwd.cu`` are made by text substitution (a
substitution that finds no anchor raises: the script is tied to those
sources) and built side by side, one ``nvcc`` each, each with its switches
defined at the top of its source:

  * ``BD_LEVELS``: a bit mask of the levels whose points the kernel
    gathers (the others are skipped);
  * ``BD_SHFL``: each point's geometry computed once a group: lane q of
    the group computes point kb + q, and the group's lanes take the four
    corner indices and weights of each point from it with 8 shuffles
    (valid where C = G * VEC, as at C = 32: every lane reaches them);
  * ``BD_REGPTS``: the points and weights made in registers from the
    task's first point (one load a task, not three a point), to measure
    what the dependent point loads cost;
  * ``BD_ONEPIX``: every corner on the first pixel of the pyramid (the
    corner offsets times a zero the compiler cannot see);
  * ``MSDA_WARPS_PER_BLOCK``: 4 and 16 beside the default 8.

Each variant runs behind the checkout's ``cuda_fwd.msda_fwd`` (swapped in
through ``_build._LOADED``), timed in turns (all variants, then the same in
reverse order) with CUDA events and with ``torch.profiler``'s device time
of the kernel alone, at Deformable DETR's encoder and decoder shapes and
the reference workload, on uniform points (``chip_smoke.op_inputs``) and,
for the encoder and decoder, on the points of the first encoder / decoder
layer of ``chip_smoke.py``'s full-width model
(``torch_kernel_ab.model_inputs``), in f32 and bf16.  Each build's
registers (``ptxas -v``) are printed.  ``--ncu`` first tries Nsight
Compute on one encoder call of the unchanged kernel (issue-slot use, warp
stalls, L1 hit rate) and prints what it says, or why it refused.  Prints
one line per timing with the card's ``nvidia-smi`` name and power limit
and writes them to ``--out`` (default
``build/kernel_ab/fwd_breakdown.log``).  Needs a CUDA card and ``nvcc``;
exits non-zero without them.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

import torch

import torch_kernel_ab as ab
from torch_kernel_ab import cs
from torch_kernel_variants import sub
from msda_tpu_torch.ops import cuda_fwd

LIB = "msda_fwd"
SYMBOL = "msda_fwd_kernel"

SWITCHES = """
#ifndef BD_LEVELS
#define BD_LEVELS 0xFFFF
#endif
#ifndef BD_SHFL
#define BD_SHFL 0
#endif
#ifndef BD_REGPTS
#define BD_REGPTS 0
#endif
#ifndef BD_ONEPIX
#define BD_ONEPIX 0
#endif
#if BD_REGPTS
#define BD_X(k) bd_frac(x_base + 0.0371f * (float)(k))
#define BD_Y(k) bd_frac(y_base + 0.0583f * (float)(k))
#define BD_A(k) a_base
#else
#define BD_X(k) pt[2 * (k)]
#define BD_Y(k) pt[2 * (k) + 1]
#define BD_A(k) wt[k]
#endif
__device__ __forceinline__ float bd_frac(float v) { return v - floorf(v); }
"""

# the point loop with each point's geometry computed by one lane of the
# group and shuffled to the others
SHFL_LOOP = """#if BD_SHFL
      for (int kb = l * P; kb < (l + 1) * P; kb += G) {
        const int kq = min(kb + c_lane, (l + 1) * P - 1);
        const msda::Corners q = msda::corner_geometry(
            BD_X(kq), BD_Y(kq), hl, wl, off, zeros, align_corners);
        const float aq = BD_A(kq);
        const float q00 = aq * q.uy0 * q.vx0, q01 = aq * q.uy0 * q.vx1;
        const float q10 = aq * q.uy1 * q.vx0, q11 = aq * q.uy1 * q.vx1;
        const int n = min(G, (l + 1) * P - kb);
        for (int j = 0; j < n; ++j) {
          const int j00 = __shfl_sync(MSDA_FULL_MASK, q.i00, j, G);
          const int j01 = __shfl_sync(MSDA_FULL_MASK, q.i01, j, G);
          const int j10 = __shfl_sync(MSDA_FULL_MASK, q.i10, j, G);
          const int j11 = __shfl_sync(MSDA_FULL_MASK, q.i11, j, G);
          const float w00 = __shfl_sync(MSDA_FULL_MASK, q00, j, G);
          const float w01 = __shfl_sync(MSDA_FULL_MASK, q01, j, G);
          const float w10 = __shfl_sync(MSDA_FULL_MASK, q10, j, G);
          const float w11 = __shfl_sync(MSDA_FULL_MASK, q11, j, G);
          const float4 v00 = load_vec<VEC>(img_bh + j00 * HC * bd_keep + c);
          const float4 v01 = load_vec<VEC>(img_bh + j01 * HC * bd_keep + c);
          const float4 v10 = load_vec<VEC>(img_bh + j10 * HC * bd_keep + c);
          const float4 v11 = load_vec<VEC>(img_bh + j11 * HC * bd_keep + c);
          acc.x += w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
          acc.y += w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
          acc.z += w00 * v00.z + w01 * v01.z + w10 * v10.z + w11 * v11.z;
          acc.w += w00 * v00.w + w01 * v01.w + w10 * v10.w + w11 * v11.w;
        }
      }
#else
"""


def instrumented(k1: str) -> str:
    """cc78811's K1 with the switches (default: the kernel as it is)."""
    text = sub(k1, '#include "msda_lanes.cuh"\n',
               '#include "msda_lanes.cuh"\n' + SWITCHES)
    # a group past the last task stays (with the last task's data, storing
    # nothing), so that every lane of a warp reaches the shuffles
    text = sub(text, "  const int64_t t =\n", "  const int64_t t_raw =\n")
    text = sub(text, "  if (t >= num_tasks) return;\n",
               "  const bool live = t_raw < num_tasks;\n"
               "  if (!live && !BD_SHFL) return;\n"
               "  const int64_t t = live ? t_raw : num_tasks - 1;\n"
               "  const int64_t bd_keep = BD_ONEPIX ? (I == INT_MAX ? 1 : 0)"
               " : 1;\n")
    text = sub(text, "  T* out_row = out + task * (int64_t)C;\n",
               "  T* out_row = out + task * (int64_t)C;\n"
               "  const float x_base = pt[0], y_base = pt[1], "
               "a_base = wt[0];\n"
               "  (void)x_base; (void)y_base; (void)a_base;\n")
    text = sub(text, "    for (int l = 0; l < L; ++l) {\n",
               "    for (int l = 0; l < L; ++l) {\n"
               "      if (!((BD_LEVELS >> l) & 1)) continue;\n")
    text = sub(text, "#pragma unroll 4\n      for (int k = l * P;",
               SHFL_LOOP + "#pragma unroll 4\n      for (int k = l * P;")
    text = sub(text, "            pt[2 * k], pt[2 * k + 1], hl, wl,",
               "            BD_X(k), BD_Y(k), hl, wl,")
    text = sub(text, "        const float a = wt[k];\n",
               "        const float a = BD_A(k);\n")
    text = sub(text, "* HC + c);", "* HC * bd_keep + c);")
    text = sub(text, "        acc.w += w00 * v00.w + w01 * v01.w + w10 * "
               "v10.w + w11 * v11.w;\n      }\n",
               "        acc.w += w00 * v00.w + w01 * v01.w + w10 * "
               "v10.w + w11 * v11.w;\n      }\n#endif\n")
    return sub(text, "    store_vec<VEC>(out_row + c, acc);\n",
               "    if (live) store_vec<VEC>(out_row + c, acc);\n")


def variants(levels: int) -> dict:
    """{tag: {define: value}} of the variants."""
    out = {"as_is": {}}
    for lvl in range(levels):
        out[f"L{lvl}"] = {"BD_LEVELS": 1 << lvl}
    out["shfl_geometry"] = {"BD_SHFL": 1}
    out["reg_points"] = {"BD_REGPTS": 1}
    out["shfl_reg_points"] = {"BD_SHFL": 1, "BD_REGPTS": 1}
    out["one_pixel"] = {"BD_ONEPIX": 1}
    out["warps4"] = {"MSDA_WARPS_PER_BLOCK": 4}
    out["warps16"] = {"MSDA_WARPS_PER_BLOCK": 16}
    return out


def build_variants(parent: str, tags: dict) -> dict:
    """Build every variant of the parent's K1 and the parent's source as it
    is (``parent``); {tag: CDLL}."""
    with open(os.path.join(parent, LIB + ".cu")) as f:
        text = instrumented(f.read())
    with open(os.path.join(parent, LIB + ".cu")) as f:
        jobs = {(LIB, "parent"): f.read()}  # the source untouched
    include = {(LIB, "parent"): parent}
    for tag, defines in tags.items():
        head = "".join(f"#define {k} {v}\n" for k, v in defines.items())
        jobs[(LIB, tag)] = head + text
        include[(LIB, tag)] = parent
    return {tag: lib for (_, tag), lib in ab.build(jobs, include).items()}


NCU_CALL = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
from msda_tpu_torch.ops import cuda_fwd
import torch
case = cs.OP_CASES["encoder"]
img, pts, wts = cs.op_inputs(**case)
for _ in range(3):
    cuda_fwd.msda_fwd(img, case["shapes"], pts, wts)
torch.cuda.synchronize()
"""
NCU_METRICS = ",".join((
    "sm__inst_issued.avg.pct_of_peak_sustained_active",
    "smsp__issue_active.avg.pct_of_peak_sustained_active",
    "smsp__warps_active.avg.pct_of_peak_sustained_active",
    "l1tex__t_sector_hit_rate.pct",
    "lts__t_sector_hit_rate.pct",
    "smsp__average_warp_latency_issue_stalled_long_scoreboard",
    "smsp__average_warp_latency_issue_stalled_lg_throttle",
    "smsp__average_warp_latency_issue_stalled_barrier",
    "smsp__average_warp_latency_issue_stalled_short_scoreboard",
    "smsp__average_warp_latency_issue_stalled_math_pipe_throttle",
))


def try_ncu() -> None:
    """One Nsight Compute profile of K1's third encoder call; logs what it
    printed, or why it did not run."""
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not os.path.exists(ncu):
        ab.log("ncu: not installed on this machine")
        return
    cmd = [ncu, "--kernel-name", f"regex:{SYMBOL}", "--launch-skip", "2",
           "--launch-count", "1", "--metrics", NCU_METRICS, sys.executable,
           "-c", NCU_CALL.format(root=ab.ROOT)]
    try:
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=240)
        text = (run.stdout + run.stderr).strip().splitlines()
        ab.log(f"ncu: exit {run.returncode}")
        for line in text[-40:]:
            ab.log(f"ncu: {line}")
    except subprocess.TimeoutExpired:
        ab.log("ncu: no result within 240 s")


CASES = (
    ("encoder", "encoder", lambda: cs.op_inputs(**cs.OP_CASES["encoder"]),
     20),
    ("encoder_model", "encoder", lambda: ab.model_inputs(0)[:3], 20),
    ("decoder", "decoder", lambda: cs.op_inputs(**cs.OP_CASES["decoder"]),
     200),
    ("decoder_model", "decoder", lambda: ab.model_inputs(6)[:3], 200),
    ("reference_workload", "reference_workload",
     lambda: cs.op_inputs(**cs.OP_CASES["reference_workload"]), 20),
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="cc78811's msda_tpu_torch/csrc")
    ap.add_argument("--ncu", action="store_true",
                    help="first try Nsight Compute on the unchanged kernel")
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "fwd_breakdown.log"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    if args.ncu:
        try_ncu()
    tags = variants(len(cs.SLICE_SHAPES))
    libs = build_variants(args.parent, tags)
    for case_name, op_case, make, iters in CASES:
        img32, pts, wts = make()
        shapes = cs.OP_CASES[op_case]["shapes"]
        for dtype in (torch.float32, torch.bfloat16):
            img = img32.to(dtype)

            def call():
                return cuda_fwd.msda_fwd(img, shapes, pts, wts)

            want = None
            for tag in ("parent", "as_is", "shfl_geometry", "warps4",
                        "warps16"):
                ab.swap(LIB, libs[tag])
                got = call()
                if want is None:
                    want = got
                err = (got.float() - want.float()).abs().max().item()
                ab.log(f"breakdown {case_name:18s} {str(dtype)[6:]:8s} "
                       f"{tag} against parent: max abs {err:.3e}")
            del want, got
            res = ab.in_turns({tag: ab.timed(LIB, lib, call)
                               for tag, lib in libs.items()}, iters, SYMBOL)
            full = res["parent"]["kernel"][0]
            for tag, r in res.items():
                ev, dev = r["events"], r["kernel"]
                ab.log(f"breakdown {case_name:18s} {str(dtype)[6:]:8s} "
                       f"{tag:16s}: device {dev[0]:.4f} ms ({dev[1]:.4f}, "
                       f"{dev[2]:.4f}), {100 * dev[0] / full:.1f}% of parent;"
                       f" events {ev[0]:.4f} ms ({ev[1]:.4f}, {ev[2]:.4f})"
                       f" on {smi}")
            del img
        del img32, pts, wts
    ab.log(f"breakdown done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
