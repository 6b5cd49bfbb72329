#!/usr/bin/env python3
"""Ablations of the redesigned streamed kernels K3' / K4'+K5', made by text
substitution and timed in turns against the kernels as they are, on one
NVIDIA GPU: the measurements behind their design and constants (``PERF.md``,
"The streamed kernels redesigned").

    python3 docs/experiments/torch_stream_ablations.py

It is a record tied to the ``msda_stream.cu`` of the commit that added it
(the checkout's); on other sources a substitution that finds no anchor
raises.  Each variant is a whole library behind the same wrappers
(``cuda_stream``), swapped in through ``_build._LOADED``:
  * of the work split: one chunk of the cost line per block (a static
    split), twice and half the chunks per block, and twice and half a
    sample's weight on the cost line;
  * of both kernels: no tile staging (results wrong);
  * of K3': no group loop (staging, records and geometry only), no ``out``
    atomics (the sums kept in a register);
  * of K4'+K5': no ``img_grad`` atomics, no point and weight gradients
    written, no pixel sort (the binning's order), no merging of runs (every
    sample adds), no group sums.
Timed at the 256-base pyramid (B=4, N=10,000, uniform points) and at encoder
layer 0's call of the full-width model at 1600x2666 (B=2, the model's own
points), in f32 (the split's variants in bf16 too): CUDA events around the
wrapper and ``torch.profiler``'s device time of the kernel alone.  Writes
its lines to ``--out`` (default ``build/kernel_ab/stream_ablations.log``).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

import torch_kernel_ab as ab
from torch_kernel_ab import cs
from msda_tpu_torch.ops import _build, cuda_stream


# the cases of ``torch_kernel_ab.STREAM_CASES`` it times
CASES = ("big_pyramid", "model_1600x2666")


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"ablation: {text.count(old)} matches for "
                         f"{old[:60]!r}, expected 1")
    return text.replace(old, new)


def split_variants(src: str) -> dict:
    """The work split's constants, doubled and halved."""
    chunks = ("#define FWD_CHUNKS_PER_BLOCK 4\n"
              "#define BWD_CHUNKS_PER_BLOCK 8")
    weights = ("#define FWD_SAMPLE_BYTES 256\n"
               "#define BWD_SAMPLE_BYTES 768")
    return {
        "one_chunk_per_block": sub(src, chunks, (
            "#define FWD_CHUNKS_PER_BLOCK 1\n"
            "#define BWD_CHUNKS_PER_BLOCK 1")),
        "chunks_x2": sub(src, chunks, ("#define FWD_CHUNKS_PER_BLOCK 8\n"
                                       "#define BWD_CHUNKS_PER_BLOCK 16")),
        "chunks_half": sub(src, chunks, ("#define FWD_CHUNKS_PER_BLOCK 2\n"
                                         "#define BWD_CHUNKS_PER_BLOCK 4")),
        "sample_weight_x2": sub(src, weights, (
            "#define FWD_SAMPLE_BYTES 512\n"
            "#define BWD_SAMPLE_BYTES 1536")),
        "sample_weight_half": sub(src, weights, (
            "#define FWD_SAMPLE_BYTES 128\n"
            "#define BWD_SAMPLE_BYTES 384")),
    }


def work_variants(src: str) -> dict:
    """What each part of the kernels costs."""
    no_staging = sub(src, "  if (vec) {\n    constexpr int E = 16 / "
                     "sizeof(T);", "  if (vec && C < 0) {\n"
                     "    constexpr int E = 16 / sizeof(T);")
    no_staging = sub(no_staging, "  } else {\n    const int n = t.rows * "
                     "t.cols * C;\n    for (int e = threadIdx.x;",
                     "  } else if (!vec) {\n    const int n = t.rows * "
                     "t.cols * C;\n    for (int e = threadIdx.x;")
    fwd_loop = ("         const int first = g.group * per, "
                "last = min(n, first + per);")
    no_out = sub(src, "             if (g.merge) {\n"
                 "               axpy4(acc, 1.f, v);\n"
                 "             } else {\n"
                 "               red<VEC>(out + (int64_t)m.x * C + c, v);\n"
                 "             }", "             axpy4(acc, 1.f, v);")
    no_out = sub(no_out, "             if (row >= 0 && g.c0 < C) {\n"
                 "               red<VEC>(out + (int64_t)row * C + g.c0, acc);"
                 "\n             }\n", "")
    no_out = sub(no_out, "         if (g.merge && row >= 0 && g.c0 < C) {\n"
                 "           red<VEC>(out + (int64_t)row * C + g.c0, acc);\n"
                 "         }",
                 "         if (acc.x == 12345.f) out[0] = acc.y;")
    sort_start = "         __syncthreads();\n         {\n"
    sort_end = ("             hist[k] = 0;  // for the next slice\n"
                "           }\n         }\n")
    i = src.index(sort_start) + len("         __syncthreads();\n")
    j = src.index(sort_end) + len(sort_end)
    no_sort = sub(src[:i] + src[j:], "           atomicAdd(hist + key, 1);\n",
                  "")
    no_sort = sub(no_sort, "           const int e = valid ? perm[k] : 0;",
                  "           const int e = valid ? k : 0;")
    return {
        "no_staging": no_staging,
        "fwd_no_group_loop": sub(src, fwd_loop, fwd_loop.replace(
            "min(n, first + per);", "first;")),
        "fwd_no_out_atomics": no_out,
        "bwd_no_img_grad_atomics": sub(
            src, "           if (g.c0 >= C) return;\n",
            "           if (g.c0 >= C || nz >= 0) return;\n").replace(
                "               } else {\n"
                "                 add_grad<VEC>",
                "               } else if (a == 12345.f) {\n"
                "                 add_grad<VEC>"),
        "bwd_no_gradient_output": sub(
            src, "           if (valid && (threadIdx.x & 31) % G == 0) {\n"
            "             pts_grad[s] =",
            "           if (valid && (threadIdx.x & 31) % G == 0 && "
            "sum_w == 12345.f) {\n             pts_grad[s] ="),
        "bwd_no_sort": no_sort,
        "bwd_no_merge": sub(src, "  g.merge = C <= g.step;\n",
                            "  g.merge = C < 0;\n"),
        "bwd_no_group_sums": sub(
            src, "           sum_w = group_sum(sum_w, G);\n"
            "           sum_x = group_sum(sum_x, G);\n"
            "           sum_y = group_sum(sum_y, G);\n", ""),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "stream_ablations.log"),
                    help="where to write the lines printed")
    ap.add_argument("--iters", type=int, default=10,
                    help="launches per timing")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    with open(os.path.join(_build.CSRC_DIR, "msda_stream.cu")) as f:
        src = f.read()
    split, work = split_variants(src), work_variants(src)
    jobs = {("msda_stream", v): text
            for v, text in {**split, **work}.items()}
    libs = ab.build(jobs, {key: str(_build.CSRC_DIR) for key in jobs})
    libs[("msda_stream", "as_is")] = _build.load_library("msda_stream")
    for case, shapes, make in ab.STREAM_CASES:
        if case not in CASES:
            continue
        img32, pts, wts, og32 = make()
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            for name, call in (
                    ("msda_stream_fwd", lambda: cuda_stream.msda_stream_fwd(
                        img, shapes, pts, wts)),
                    ("msda_stream_bwd", lambda: cuda_stream.msda_stream_bwd(
                        img, shapes, pts, wts, og))):
                names = ["as_is", *split]
                if dtype == torch.float32:
                    names += [v for v in work if v == "no_staging"
                              or v.startswith(name[-3:])]
                res = ab.in_turns(
                    {v: ab.timed("msda_stream", libs[("msda_stream", v)],
                                 call) for v in names},
                    args.iters, name + "_kernel")
                for v, r in res.items():
                    ab.log(f"ablation {name} {case} {str(dtype)[6:]} {v:24s}"
                           f" ms: kernel {r['kernel'][0]:.4f}, events "
                           f"{r['events'][0]:.4f}; as is / this kernel "
                           f"{res['as_is']['kernel'][0] / r['kernel'][0]:.2f}"
                           f"x on {smi}")
            ab.swap("msda_stream", libs[("msda_stream", "as_is")])
            del img, og
        del img32, pts, wts, og32
    ab.log(f"stream ablations done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
