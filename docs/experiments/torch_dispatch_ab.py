#!/usr/bin/env python3
"""A/B timing of serving and training (``chip_smoke.py`` phases 4 and 5)
and of the op's host dispatch, this tree against an earlier one, on one
NVIDIA GPU.

    git archive <commit> | tar -x -C build/ab_parent
    python3 docs/experiments/torch_dispatch_ab.py --parent build/ab_parent

Written for the change that put the CUDA path of
``multiscale_deformable_attention`` on ``torch.library`` operators
(``ops/library.py``), whose dispatcher and autograd formula add host time
to each of the model's 12 op calls a forward (and 12 backward calls a
training step), where the earlier tree called a ``torch.autograd.Function``
directly.  Each tree runs in its own Python process (both packages are
named ``msda_tpu_torch``), in turns: earlier, this, this, earlier (``--rounds
2``; each round adds a pair).  A process builds its tree's kernels into
its own ``build/``, then:

  * ``dispatch``: the op's call alone at the decoder's shapes (B=2, N=300,
    the 800x1333 pyramid, f32), whose kernels take microseconds, so the
    time per call is the host's: ``--calls`` forward calls under
    ``inference_mode``, then forward + backward calls through autograd,
    each run timed on the host clock up to a ``synchronize``;
  * ``chip_smoke.serve`` (phase 4, ``--serve-repeats`` times: 3 requests
    of batch 2 a time, f32 and bf16) and ``chip_smoke.train`` (phase 5:
    5 timed steps f32 and bf16, one remat step), as the tree's
    ``chip_smoke.py`` runs them, its lines parsed for the mean request
    and step times.

Prints each process's numbers and each tree's means with the card's
``nvidia-smi`` name and power limit, and writes them to ``--out`` (default
``build/dispatch_ab.log``).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# run in a tree's root with that tree first on sys.path
_CHILD = r"""
import json, re, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from msda_tpu_torch.ops import multiscale_deformable_attention as msda

args = json.loads(sys.argv[2])
smi = cs.setup()
img, pts, wts = cs.op_inputs(**cs.OP_CASES["decoder"])
shapes = cs.OP_CASES["decoder"]["shapes"]


def host_ms(fn, n):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def forward():
    with torch.inference_mode():
        msda(img, shapes, pts, wts, impl="cuda")


leaves = [t.detach().requires_grad_(True) for t in (img, pts, wts)]


def forward_backward():
    out = msda(leaves[0], shapes, *leaves[1:], impl="cuda")
    torch.autograd.grad(out, leaves, out)


result = {"fwd_call_ms": host_ms(forward, args["calls"]),
          "fwdbwd_call_ms": host_ms(forward_backward, args["calls"])}
for _ in range(args["serve_repeats"]):
    cs.serve(smi)
cs.train(smi)
print("RESULT " + json.dumps(result), flush=True)
"""

_SERVE_LINE = re.compile(r"^serving (f32|bf16): .*\(mean ([0-9.]+)\)")
_TRAIN_LINE = re.compile(r"^train (f32|bf16|f32 remat): .* mean step "
                         r"([0-9.]+) ms")


def run_tree(tree: str, args) -> dict:
    spec = json.dumps({"calls": args.calls,
                       "serve_repeats": args.serve_repeats})
    proc = subprocess.run([sys.executable, "-c", _CHILD, tree, spec],
                          cwd=tree, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    result = json.loads(next(line for line in lines
                             if line.startswith("RESULT "))[7:])
    serve, train = {}, {}
    for line in lines:
        for pattern, into in ((_SERVE_LINE, serve), (_TRAIN_LINE, train)):
            m = pattern.match(line)
            if m:
                into.setdefault(m.group(1), []).append(float(m.group(2)))
    result["serve_ms"] = {k: sum(v) / len(v) for k, v in serve.items()}
    result["train_ms"] = {k: sum(v) / len(v) for k, v in train.items()}
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", required=True,
                    help="root of the earlier tree (git archive)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--serve-repeats", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "dispatch_ab.log"))
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    order = []
    for i in range(args.rounds):  # parent, change, change, parent, ...
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    for tag in order:
        r = run_tree(trees[tag], args)
        runs[tag].append(r)
        log(f"{tag}: op call fwd {r['fwd_call_ms']:.4f} ms, fwd+bwd "
            f"{r['fwdbwd_call_ms']:.4f} ms; serving (mean request) "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in r["serve_ms"].items())
            + "; training (mean step) "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in r["train_ms"].items())
            + f" on {smi}")
    for tag, rs in runs.items():
        def mean(get):
            return sum(get(r) for r in rs) / len(rs)
        log(f"{tag} mean of {len(rs)}: op call fwd "
            f"{mean(lambda r: r['fwd_call_ms']):.4f} ms, fwd+bwd "
            f"{mean(lambda r: r['fwdbwd_call_ms']):.4f} ms; serving "
            + ", ".join(f"{k} {mean(lambda r: r['serve_ms'][k]):.3f} ms"
                        for k in rs[0]["serve_ms"])
            + "; training "
            + ", ".join(f"{k} {mean(lambda r: r['train_ms'][k]):.3f} ms"
                        for k in rs[0]["train_ms"])
            + f" on {smi}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
