#!/usr/bin/env python3
"""K1's prologue variant (``msda_fwd_queries``) against the module's chain
+ K1 and against K1 alone, on the serve cell's own calls, on one NVIDIA GPU.

    python3 docs/experiments/torch_fwd_queries_ab.py [--dtype bfloat16]

The serve cell's detector (``perfbench/configs/ddetr-refine.json``, the
weights drawn from ``--seed`` as the benchmark draws them, batch 2) at
800x1333 under ``inference_mode``; the variant's arguments at encoder
layer 0 and decoder layer 0 are taken by a spy on
``library.msda_fwd_queries``.  Each version's ``--calls`` calls on fresh
operands are captured as one CUDA graph; a call's time is a replay's device
time on CUDA events over the calls, the median of ``--repeats`` replays,
the versions in turns (variant, chain + K1, K1 alone on the chain's points
and weights, then backwards, twice).  The outputs are held to the chain +
K1's: the share bitwise equal.  The designs that lost to the shipped one
(a task's softmax in registers, a point a lane, then its geometry) at the
encoder / decoder call in bf16: the weights written to shared memory and
the points placed after a block barrier, 0.2557 / 0.0114 ms, and both
designs in one kernel, chosen at run time, 0.2459 / 0.0183 ms, where the
shipped design gave 0.2406 / 0.0134 (NVIDIA H100 80GB HBM3, 700 W).
Prints one JSON line with the card's name and power limit (and writes it to
``--out`` when given).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from msda_tpu_torch.ops import cuda_fwd, cuda_fwd_queries, library  # noqa: E402
from perfbench import inputs, program  # noqa: E402

ARGS = ("reference", "border", False)


class _Captured(Exception):
    pass


def captured_calls(dtype, seed, hw=(800, 1333)) -> dict:
    """The variant's arguments at encoder layer 0 and decoder layer 0."""
    dev = torch.device("cuda")
    cfg = json.loads((ROOT / "perfbench/configs/ddetr-refine.json")
                     .read_text())
    weights = inputs.detector_weights(cfg, seed, dev)
    model = program.detector(cfg, weights, dev, dtype).eval()
    pyramid = inputs.pyramid(cfg, hw, 2, inputs.generator(seed, dev, "ab"),
                             dev)
    calls, real = [], library.msda_fwd_queries
    want = {0: "encoder", cfg["num_encoder_layers"]: "decoder"}

    def spy(img, q, refs, *rest):
        if len(calls) in want:
            if refs.stride(0) == 0:  # the encoder's [I, 2], expanded
                refs = refs[:1].clone().expand(refs.shape)
            else:
                refs = refs.clone()
            calls.append((want[len(calls)], img.clone(), q.clone(), refs))
        else:
            calls.append(None)
        if len(calls) > max(want):
            raise _Captured
        return real(img, q, refs, *rest)

    library.msda_fwd_queries = spy
    try:
        with torch.inference_mode():
            model(pyramid, program.shapes_of(pyramid))
    except _Captured:
        pass
    finally:
        library.msda_fwd_queries = real
    shapes = program.shapes_of(pyramid)
    return {c[0]: (c[1], shapes, c[2], c[3]) for c in calls if c}


def replay_ms(fn, operands, repeats) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in operands:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in operands:
            fn(*args)
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(operands))
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--seed", type=int, default=2_000_000_011)
    ap.add_argument("--calls", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dtype = program.dtype(args.dtype)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"card": smi.strip(), "dtype": args.dtype, "calls": {}}
    for name, (img, shapes, q, refs) in captured_calls(
            None if dtype == torch.float32 else dtype, args.seed).items():
        hw = torch.tensor(shapes, dtype=torch.float32, device=img.device)

        def variant(x, y, r):
            return cuda_fwd_queries.msda_fwd_queries(x, shapes, y, r, *ARGS)

        def chain(x, y, r):
            pts, wts = cuda_fwd_queries.sampling_plain(y, r, shapes, ARGS[0],
                                                       hw)
            return cuda_fwd.msda_fwd(x, shapes, pts, wts, *ARGS[1:])

        pts, wts = cuda_fwd_queries.sampling_plain(q, refs, shapes, ARGS[0],
                                                   hw)

        def k1(x, p, w):
            return cuda_fwd.msda_fwd(x, shapes, p, w, *ARGS[1:])

        with torch.inference_mode():
            want = chain(img, q, refs)
            equal = {"variant": (variant(img, q, refs) == want).float()
                     .mean().item()}
            versions = {"variant": (variant, None), "chain_k1": (chain, None),
                        "k1": (k1, "points")}
            operands = [(img.clone(), q.clone(), refs)
                        for _ in range(args.calls)]
            points = [(x, pts.clone(), wts.clone()) for x, _, _ in operands]
            times = {version: [] for version in versions}
            order = list(versions)
            for turn in order + order[::-1]:
                fn, kind = versions[turn]
                times[turn].append(replay_ms(
                    fn, points if kind else operands, args.repeats))
        row = {k: statistics.mean(v) for k, v in times.items()}
        row["runs"] = times
        row["bitwise_equal"] = equal
        row["q"] = list(q.shape)
        result["calls"][name] = row
        print(f"{name} {tuple(q.shape)} {args.dtype}: variant "
              f"{row['variant']:.5f} ms, chain + K1 {row['chain_k1']:.5f}, "
              f"K1 alone {row['k1']:.5f}; bitwise equal {equal}, on "
              f"{smi.strip()}", flush=True)
        del operands, points
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
