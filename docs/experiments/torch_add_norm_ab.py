#!/usr/bin/env python3
"""The detector's residual add + LayerNorm on one NVIDIA GPU: the fused
kernel (``csrc/msda_norm.cu``, through the operator
``torch.ops.msda_tpu_torch.add_layer_norm``) against the four-kernel chain
it replaced (the bf16 add, the cast to f32,
``F.layer_norm`` in f32, the cast back) and against the shortest chain of
library calls: the bf16 add, then ``F.layer_norm`` of the bf16 sum with
the f32 weight and bias (``mixed``; on the CPU that returns bf16, on the
card it may raise, and the error is printed instead) and with the weight
and bias cast once, outside the timed calls, to the activations' dtype
(``half_weights``: what half-type copies beside the masters would give),
in one process.

    python3 docs/experiments/torch_add_norm_ab.py [--dtype bfloat16]

The shapes: the encoder's rows at each of the serve cell's eight sizes
(``perfbench/traffic/serve-bf16-coco8.json``: batch 2, the pyramid at
strides 8, 16, 32 and 64 of ``perfbench/configs/ddetr-refine.json``, D =
256) and the decoder's 600 rows (batch 2 x 300 queries).  Each version's
``--calls`` back-to-back calls on fresh operands a call (so that the
chain's inputs are not its outputs) are captured as one CUDA graph, as a
served request replays them; the time of a call is a replay's device time
on CUDA events over the calls, the median of ``--repeats`` replays, the two
versions in turns (fused, chain, half_weights, then backwards, ...).  The
bound is the bytes a call needs (a and b read once, out written once: 6 D
bytes a row) at 3.35 TB/s.  Each version's outputs are held to the
chain's: the share bitwise equal and the widest gap in ulps (taken at the
output's magnitude, no finer than at 2**-10).  Prints one JSON line, with the
card's name and power limit (and writes it to ``--out`` when given).
Needs a CUDA card and ``nvcc``.
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

from msda_tpu_torch.models.detr import LAYER_NORM_EPS  # noqa: E402
from msda_tpu_torch.ops import cuda_norm, library  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
DECODER_ROWS = 2 * 300


def shapes() -> list[tuple[str, int]]:
    """``(name, rows)`` of the serve cell's encoder calls and the
    decoder's."""
    cfg = json.loads((ROOT / "perfbench/configs/ddetr-refine.json")
                     .read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/serve-bf16-coco8.json")
                         .read_text())
    out = []
    for h, w in traffic["sizes"]:
        tokens = sum(-(-h // s) * -(-w // s) for s in cfg["strides"])
        out.append((f"encoder {h}x{w}", traffic["batch"] * tokens))
    out.append(("decoder", DECODER_ROWS))
    return out


def chain(a, b, weight, bias):
    y = torch.nn.functional.layer_norm(
        (a + b).to(torch.float32), (a.shape[-1],), weight, bias,
        LAYER_NORM_EPS)
    return y.to(a.dtype)


def mixed(a, b, weight, bias):
    return torch.nn.functional.layer_norm(a + b, (a.shape[-1],), weight,
                                          bias, LAYER_NORM_EPS)


def fused(a, b, weight, bias):
    return library.add_layer_norm(a, b, weight, bias, LAYER_NORM_EPS)


def half_weights(weight, bias, dtype):
    """``mixed`` with the weight and bias cast to ``dtype`` once."""
    w, c = weight.to(dtype), bias.to(dtype)
    return lambda a, b, _weight, _bias: mixed(a, b, w, c)


def mixed_error(dtype, weight, bias) -> str | None:
    """The error ``mixed`` raises on the card, or None if it runs."""
    x = torch.ones(8, weight.shape[0], device=weight.device, dtype=dtype)
    try:
        mixed(x, x, weight, bias)
    except RuntimeError as err:
        return str(err)
    return None


def ulps(got, want, floor=2.0**-10):
    """``|got - want|`` in ulps of the output dtype, each taken at the
    larger of the two magnitudes and ``floor`` (as the card tests,
    ``tests/test_torch_norm.py``, measure it)."""
    bits = {torch.bfloat16: 7, torch.float16: 10}[got.dtype]
    g, w = got.float(), want.float()
    scale = torch.maximum(torch.maximum(g.abs(), w.abs()),
                          torch.tensor(floor, device=g.device))
    _, exponent = torch.frexp(scale)
    return (g - w).abs() / torch.ldexp(torch.ones_like(scale),
                                       exponent - 1 - bits)


def captured(fn, operands, weight, bias):
    """``fn`` on each pair of ``operands``, captured as one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a, b in operands:  # load the kernels before the capture
            fn(a, b, weight, bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(a, b, weight, bias) for a, b in operands]
    return graph, outs


def replay_ms(graph) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float16"))
    parser.add_argument("--calls", type=int, default=12)
    parser.add_argument("--repeats", type=int, default=30)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda")
    D = 256
    g = torch.Generator(device=dev).manual_seed(0)
    weight = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    bias = 0.1 * torch.randn(D, generator=g, device=dev)
    rows_out = []
    versions = {"fused": fused, "chain": chain,
                "half_weights": half_weights(weight, bias, dtype)}
    error = mixed_error(dtype, weight, bias)
    print(json.dumps({"mixed_error": error}), flush=True)
    if error is None:
        versions["mixed"] = mixed
    with torch.inference_mode():
        for name, rows in shapes():
            operands = [tuple(torch.randn(rows, D, generator=g, device=dev)
                              .to(dtype) for _ in range(2))
                        for _ in range(args.calls)]
            graphs = {}
            for version, fn in versions.items():
                before = cuda_norm.LAUNCHES
                graphs[version] = captured(fn, operands, weight, bias)
                if version == "fused":
                    launched = cuda_norm.LAUNCHES - before
                    assert launched == 2 * args.calls, launched
            for version in graphs:
                graphs[version][0].replay()
            torch.cuda.synchronize()
            want = graphs["chain"][1][0]
            times = {version: [] for version in versions}
            for r in range(args.repeats):
                order = list(versions) if r % 2 == 0 else list(versions)[::-1]
                for version in order:
                    times[version].append(
                        replay_ms(graphs[version][0]) / args.calls)
            bound_ms = 6 * rows * D / HBM_BYTES_PER_S * 1e3
            ms = {version: statistics.median(t) for version, t in
                  times.items()}
            row = {"shape": name, "rows": rows, "bound_ms": bound_ms}
            row["fused_share"] = bound_ms / ms["fused"]
            for version in versions:
                got = graphs[version][1][0]
                row[version] = {
                    "ms": ms[version],
                    "spread_ms": [min(times[version]), max(times[version])],
                    "over_fused": ms[version] / ms["fused"],
                    "bitwise_equal": (got == want).float().mean().item(),
                    "max_ulps": ulps(got, want).max().item(),
                }
            rows_out.append(row)
            print(json.dumps(rows_out[-1]), flush=True)
            del graphs, operands
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {"card": smi, "dtype": args.dtype, "calls": args.calls,
            "repeats": args.repeats, "mixed_error": error,
            "shapes": rows_out}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line) + "\n")
    print(json.dumps(line))


if __name__ == "__main__":
    main()
