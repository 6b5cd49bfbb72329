#!/usr/bin/env python3
"""Serving time of the exported full-width detector against the live
model, on one NVIDIA GPU.

    python3 docs/experiments/torch_export_serve.py [--out PATH]

Written for ``chip_smoke.py`` phase 8b, whose second process served the
exported bf16 model many times slower than phase 4 served the live one.
It separates the artifact from the process that serves it:

  * ``in-process``: ``chip_smoke.py``'s two-stage model (f32, then bf16)
    is exported with ``utils.export.export_fn`` and the bytes loaded back
    with ``load_exported`` in the same process; the live model and the
    loaded program serve the same request in turns (live, exported,
    exported, live), 5 requests a turn, timed with CUDA events, with the
    host time of each call beside it;
  * ``fresh process``: the saved artifacts (``build/export_serve/``) are
    loaded by new Python processes that import only torch, numpy and
    ``msda_tpu_torch.utils.export``, in the order ``f32,bf16`` (as
    phase 8b serves them), ``bf16`` alone and ``bf16,f32``; each serves 5
    requests after a warm-up, then one under ``cProfile`` and one under
    ``torch.profiler``, whose tables (host time by Python function and by
    operator) are printed after its row, then one with Python's garbage
    collector disabled, 280 casts of one of the artifact's constants
    to bf16 with their frees (a bf16 request casts 277 constants), and one
    run node by node through ``torch.fx.Interpreter``, synchronized after
    each node (host ms by operator, the slowest nodes with their tensor
    arguments, the constants by dtype and device), once node by node
    without the synchronizations, and one request each with its allocator
    events and on one intra-op CPU thread.  ``--orders`` picks the fresh
    processes' orders.

Prints each row with the card's ``nvidia-smi`` name and power limit and
writes them to ``--out`` (default ``build/export_serve.log``).  Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from msda_tpu_torch.utils import export_fn, load_exported, save_exported  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "export_serve")
REQUESTS = 5

_FRESH = r"""
import collections, cProfile, gc, io, json, os, pstats, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from msda_tpu_torch.utils.export import load_exported_file

spec = json.loads(sys.argv[2])
rng = np.random.default_rng(spec["seed"])
pyramid = [torch.from_numpy(rng.standard_normal(
    (spec["batch"], h, w, c), dtype=np.float32)).cuda()
    for (h, w), c in zip(spec["shapes"], spec["channels"])]
rows = {}
for name in spec["order"]:
    serve = load_exported_file(f"{spec['dir']}/{name}.pt2")
    with torch.inference_mode():
        serve(*pyramid)
        torch.cuda.synchronize()
        rows[name] = []
        for _ in range(spec["requests"]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            serve(*pyramid)
            host = (time.perf_counter() - t0) * 1e3
            end.record()
            torch.cuda.synchronize()
            rows[name].append([start.elapsed_time(end), host])
        # where the host time of one more request goes
        profile = cProfile.Profile()
        profile.enable()
        serve(*pyramid)
        torch.cuda.synchronize()
        profile.disable()
        text = io.StringIO()
        pstats.Stats(profile, stream=text).sort_stats("tottime").print_stats(8)
        rows[name + " cProfile"] = text.getvalue()[-2500:]
        with torch.profiler.profile() as prof:
            serve(*pyramid)
            torch.cuda.synchronize()
        rows[name + " ops"] = prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=10,
            max_name_column_width=40)
        # the forward's own time: Python's garbage collector, and the
        # casts of the artifact's constants with their frees
        gc_objects = len(gc.get_objects())
        gc.disable()
        t0 = time.perf_counter()
        serve(*pyramid)
        torch.cuda.synchronize()
        no_gc = (time.perf_counter() - t0) * 1e3
        gc.enable()
        constant = next(v for k, v in vars(serve).items()
                        if k.startswith("lifted_tensor")
                        and isinstance(v, torch.Tensor)
                        and v.dtype == torch.float32 and v.dim() == 2)
        t0 = time.perf_counter()
        for _ in range(280):
            cast = constant.to(torch.bfloat16)
            del cast
        torch.cuda.synchronize()
        casts = (time.perf_counter() - t0) * 1e3
        rows[name + " gc"] = (f"{gc_objects} objects tracked; a request "
                              f"with gc disabled {no_gc:.3f} ms; 280 casts "
                              f"of a constant {tuple(constant.shape)} and "
                              f"their frees {casts:.3f} ms")
        # one request node by node, synchronized after each: host ms by
        # operator, the slowest nodes with their tensor arguments, and the
        # artifact's constants by dtype and device
        timed = []

        class Timed(torch.fx.Interpreter):
            def run_node(self, n):
                args, _ = self.fetch_args_kwargs_from_env(n)
                t0 = time.perf_counter()
                out = super().run_node(n)
                torch.cuda.synchronize()
                timed.append(((time.perf_counter() - t0) * 1e3, n, args))
                return out

        t0 = time.perf_counter()
        Timed(serve).run(*pyramid)
        total = (time.perf_counter() - t0) * 1e3
        by_op = collections.Counter()
        for ms, n, _ in timed:
            by_op[str(n.target)] += ms
        lines = [f"node by node {total:.3f} ms, {len(timed)} nodes; by "
                 "operator: " + ", ".join(f"{op} {ms:.3f}"
                                          for op, ms in by_op.most_common(6))]
        for ms, n, args in sorted(timed, key=lambda r: -r[0])[:10]:
            lines.append(f"  {ms:8.3f} ms {n.target} " + ", ".join(
                f"{str(a.dtype)[6:]}{list(a.shape)}@{a.device}"
                f"{'' if a.is_contiguous() else ' strided'}"
                for a in args if isinstance(a, torch.Tensor))[:160])
        consts = collections.Counter(
            f"{str(v.dtype)[6:]}@{v.device}" for v in vars(serve).values()
            if isinstance(v, torch.Tensor))
        lines.append(f"  constants: {dict(consts)}")
        # the same node by node without the synchronizations; one request's
        # allocator events (cudaMalloc / cudaFree of segments, retries); one
        # request on one intra-op CPU thread, beside the thread counts
        t0 = time.perf_counter()
        torch.fx.Interpreter(serve).run(*pyramid)
        torch.cuda.synchronize()
        unsynced = (time.perf_counter() - t0) * 1e3
        keys = ("segment.all.allocated", "segment.all.freed",
                "num_alloc_retries", "num_device_alloc", "num_device_free",
                "num_sync_all_streams")
        before = torch.cuda.memory_stats()
        serve(*pyramid)
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        serve(*pyramid)
        torch.cuda.synchronize()
        one_thread = (time.perf_counter() - t0) * 1e3
        torch.set_num_threads(threads)
        lines.append(
            f"  node by node unsynchronized {unsynced:.3f} ms; a request's "
            "allocator events " + ", ".join(
                f"{k} {after.get(k, 0) - before.get(k, 0)}" for k in keys)
            + f"; a request on 1 intra-op thread {one_thread:.3f} ms "
            f"(default {threads} threads; {os.cpu_count()} CPUs, "
            f"{len(os.sched_getaffinity(0))} usable; PYTORCH_CUDA_ALLOC_CONF="
            f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')!r}, OMP_NUM_THREADS="
            f"{os.environ.get('OMP_NUM_THREADS')!r})")
        rows[name + " nodes"] = "\n".join(lines)
print(json.dumps(rows))
"""


def timed(fn, n):
    """``n`` calls: [(CUDA-event ms, host ms of the call)]."""
    rows = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        rows.append((start.elapsed_time(end), host))
    return rows


def fmt(rows):
    return ", ".join(f"{ev:.3f} ({host:.3f})" for ev, host in rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "export_serve.log"))
    ap.add_argument("--orders", default="f32,bf16;bf16;bf16,f32",
                    help="the fresh processes' orders, ';'-separated")
    args = ap.parse_args(argv)
    smi = cs.setup()
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    os.makedirs(OUT_DIR, exist_ok=True)
    image_sizes = torch.tensor([cs.IMAGE_HW] * cs.BATCH, device=cs.DEVICE)
    pyramid = cs.make_pyramid(cs.REQUEST_SEEDS[0])
    for name, compute_dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = cs.build_model("auto", True, compute_dtype)

        def live():
            return cs.postprocess(model(pyramid, cs.SLICE_SHAPES), top_k=100,
                                  scoring="sigmoid", image_sizes=image_sizes)

        blob = export_fn(lambda *pyr: cs.postprocess(
            model(list(pyr), cs.SLICE_SHAPES), top_k=100, scoring="sigmoid",
            image_sizes=image_sizes), *pyramid)
        save_exported(blob, os.path.join(OUT_DIR, f"{name}.pt2"))
        program = load_exported(blob)
        with torch.inference_mode():
            live()
            program(*pyramid)
            torch.cuda.synchronize()
            for tag, fn in (("live", live),
                            ("exported", lambda: program(*pyramid)),
                            ("exported", lambda: program(*pyramid)),
                            ("live", live)):
                log(f"in-process {name} {tag:8s}: request ms (host ms) "
                    f"{fmt(timed(fn, REQUESTS))} on {smi}")
        del model, program, blob
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    spec = {"dir": OUT_DIR, "seed": cs.REQUEST_SEEDS[0], "batch": cs.BATCH,
            "shapes": cs.SLICE_SHAPES, "channels": cs.IN_CHANNELS,
            "requests": REQUESTS}
    for order in (o.split(",") for o in args.orders.split(";")):
        run = subprocess.run(
            [sys.executable, "-c", _FRESH, ROOT,
             json.dumps(dict(spec, order=order))],
            capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"the serving process failed:\n"
                               f"{run.stderr[-3000:]}")
        rows = json.loads(run.stdout.strip().splitlines()[-1])
        for name in order:
            log(f"fresh process, order {','.join(order)}: {name} request ms "
                f"(host ms) {fmt(rows[name])} on {smi}")
            log(f"{name}, host time of one request by function:\n"
                f"{rows[name + ' cProfile']}\nby operator (profiler):\n"
                f"{rows[name + ' ops']}\n{name}: {rows[name + ' gc']}\n"
                f"{name}: {rows[name + ' nodes']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
