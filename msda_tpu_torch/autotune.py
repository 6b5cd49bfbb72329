"""Sweep the CUDA kernels' compile-time launch constants on the card (the
counterpart of ``scripts/autotune.py``).

    python -m msda_tpu_torch.autotune [--stream] [--queries 10000]
        [--dtype float32|bfloat16] [--iters 60] [--per-constant K]

Without ``--stream``: K1's ``MSDA_FWD_WARPS`` (the tile: 32 / G tasks a
warp), ``_STAGES``, ``_BLOCKS_PER_SM``, ``_CHUNK`` and ``_BATCH``
(``csrc/msda_fwd_plan.cuh``) and K2's ``MSDA_BWD_WARPS``, ``_STAGES``,
``_BLOCKS_PER_SM``, ``_CHUNK`` and ``_BATCH`` (``csrc/msda_bwd_plan.cuh``)
at the reference workload (``utils.bench.reference_workload``: B=4, H=8,
C=32, P=4, the 64/32/16/8 pyramid, N = ``--queries``; border,
``align_corners=True``, the mode of the repository's ``bench.py``); a
constant's variants are built and timed for the kernel it reaches only.  With
``--stream``: ``STREAM_SLICE``, ``FWD_CHUNKS_PER_BLOCK`` and
``BWD_CHUNKS_PER_BLOCK`` (``csrc/msda_stream.cu``) for K3' and K4' + K5'
at the 256-base pyramid, as whole calls (the binning included).

The constants are compile-time: each candidate is a variant library
(``_build.load_library(name, defines)``, one ``nvcc`` each, all started
together), swapped in behind the same wrappers.  One constant at a time
moves from its default (the first value of its list; ``--per-constant K``
keeps the first K values of each list).  Every variant is checked against
the plain version on the same inputs before it is timed (CUDA events,
``utils.bench.timeit_op``); one that does not build, launch or agree prints
as ``failed``.  The sweep prints each candidate's ms and the best, to be
pasted in as the new default: it changes no default itself.  It fails when
the default fails.
"""

from __future__ import annotations

import argparse
import contextlib

import torch

from .ops import _build, cuda_bwd, cuda_fwd, cuda_stream, stream
from .ops.reference import native_msda_backward, native_multiscale_deformable_attention
from .utils.bench import card_identity, reference_workload, timeit_op

__all__ = ["CANDIDATES", "STREAM_CANDIDATES", "LIBRARY_OF", "BIG_SHAPES",
           "variants", "reached",
           "swapped", "sweep", "main"]

# each constant's candidates, its default first
CANDIDATES = {
    "MSDA_FWD_WARPS": (4, 2, 8),
    "MSDA_FWD_STAGES": (3, 2, 4),
    "MSDA_FWD_BLOCKS_PER_SM": (8, 4, 16),
    "MSDA_FWD_CHUNK": (32, 8, 64),
    "MSDA_FWD_BATCH": (2, 1, 4),
    "MSDA_BWD_WARPS": (4, 2, 8),
    "MSDA_BWD_STAGES": (3, 2, 4),
    "MSDA_BWD_BLOCKS_PER_SM": (8, 4, 16),
    "MSDA_BWD_CHUNK": (32, 8, 64),
    "MSDA_BWD_BATCH": (4, 1, 2),
}
# the library each constant reaches (a variant is built for that one only)
LIBRARY_OF = {name: cuda_fwd.KERNEL if name.startswith("MSDA_FWD_")
              else cuda_bwd.KERNEL for name in CANDIDATES}
STREAM_CANDIDATES = {
    "STREAM_SLICE": (512, 256, 1024),
    "FWD_CHUNKS_PER_BLOCK": (4, 2, 8),
    "BWD_CHUNKS_PER_BLOCK": (8, 4, 16),
}
BIG_SHAPES = ((256, 256), (128, 128), (64, 64), (32, 32))
# kernel against plain, |kernel - plain| <= tol * max(1, |plain|) (the
# tolerances of chip_smoke.py: about two ulps of the half types; img_grad
# is an f32 atomic sum in run-dependent order)
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: (1e-4, 1e-4, 1e-4),
            torch.bfloat16: (2e-2, 1e-4, 1e-4)}
MODE = ("border", True)


def variants(candidates: dict, per_constant: int | None = None) -> list:
    """``[(label, defines)]``: the default build, then each constant moved
    to each of its other candidates (of the first ``per_constant``)."""
    out = [("default", {})]
    for name, values in candidates.items():
        for v in values[1:per_constant]:
            out.append((f"{name}={v}", {name: v}))
    return out


def reached(defines: dict, stream_: bool = False) -> tuple:
    """The libraries a variant's ``defines`` reach: every swept library for
    the default build, else those of its constants."""
    if stream_:
        return (cuda_stream.LIBRARY,)
    if not defines:
        return (cuda_fwd.KERNEL, cuda_bwd.KERNEL)
    return tuple(sorted({LIBRARY_OF[name] for name in defines}))


@contextlib.contextmanager
def swapped(libraries, defines):
    """Within the block the wrappers of ``libraries`` launch the variant
    built with ``defines``."""
    saved = {name: _build._LOADED.get(name) for name in libraries}
    try:
        for name in libraries:
            variant = _build.load_library(name, defines)
            _build._LOADED[name] = variant
        yield
    finally:
        for name, lib in saved.items():
            if lib is None:
                _build._LOADED.pop(name, None)
            else:
                _build._LOADED[name] = lib


def _error(got, want) -> float:
    diff = (got.float() - want.float()).abs()
    return (diff / want.float().abs().clamp(min=1.0)).max().item()


def _cases(stream_: bool, queries: int, dtype):
    """``{kernel: (call, check)}``: ``call()`` launches the kernel,
    ``check(out)`` returns its error against the plain version (computed
    once here) or raises when it exceeds the tolerance."""
    shapes = BIG_SHAPES if stream_ else None
    img, shapes, pts, wts, og = reference_workload(
        num_queries=queries, dtype=dtype, shapes=shapes, device="cuda")
    pts, wts = pts.float(), wts.float()
    if stream_:
        fwd = (lambda: cuda_stream.msda_stream_fwd(img, shapes, pts, wts,
                                                   *MODE),
               stream.plain_stream_fwd(img, shapes, pts, wts, *MODE))
        bwd = (lambda: cuda_stream.msda_stream_bwd(img, shapes, pts, wts, og,
                                                   *MODE),
               stream.plain_stream_bwd(img, shapes, pts, wts, og, *MODE))
        names = ("msda_stream_fwd", "msda_stream_bwd")
    else:
        fwd = (lambda: cuda_fwd.msda_fwd(img, shapes, pts, wts, *MODE),
               native_multiscale_deformable_attention(img, shapes, pts, wts,
                                                      *MODE))
        bwd = (lambda: cuda_bwd.msda_bwd(img, shapes, pts, wts, og, *MODE),
               native_msda_backward(img, shapes, pts, wts, og, *MODE))
        names = (cuda_fwd.KERNEL, cuda_bwd.KERNEL)

    def check_fwd(out):
        err = _error(out, fwd[1])
        if not err <= FWD_TOL[dtype]:
            raise AssertionError(f"error {err:.3e} against the plain "
                                 f"version, tolerance {FWD_TOL[dtype]:g}")
        return err

    def check_bwd(out):
        errs = [_error(g, w) for g, w in zip(out, bwd[1])]
        if not all(e <= t for e, t in zip(errs, GRAD_TOL[dtype])):
            raise AssertionError(f"gradient errors {errs} against the plain "
                                 f"version, tolerances {GRAD_TOL[dtype]}")
        return max(errs)

    return {names[0]: (fwd[0], check_fwd), names[1]: (bwd[0], check_bwd)}


def sweep(stream_: bool = False, queries: int = 10000,
          dtype=torch.float32, iters: int = 60,
          per_constant: int | None = None, log=print) -> dict:
    """Build, check and time every variant; returns ``{kernel: {label: ms
    or None (failed)}}``.  Raises when the default fails."""
    candidates = STREAM_CANDIDATES if stream_ else CANDIDATES
    todo = variants(candidates, per_constant)
    jobs = [(name, defines) for _, defines in todo
            for name in reached(defines, stream_)]
    try:
        _build.build([n for n, _ in jobs], [d for _, d in jobs])
    except RuntimeError as e:  # the failed variants fail again below
        log(f"# some variants did not build:\n{e}")
    cases = _cases(stream_, queries, dtype)
    results = {kernel: {} for kernel in cases}
    for label, defines in todo:
        libraries = reached(defines, stream_)
        for kernel, (call, check) in cases.items():
            if not stream_ and kernel not in libraries:
                continue  # the variant is the default build for this one
            try:
                with swapped(libraries, defines):
                    err = check(call())
                    torch.cuda.synchronize()
                    ms = timeit_op(call, n=iters) * 1e3
            except (RuntimeError, AssertionError, ValueError) as e:
                if label == "default":
                    raise
                results[kernel][label] = None
                log(f"{kernel:16s} {label:26s}: failed ({type(e).__name__}:"
                    f" {str(e).splitlines()[0][:200]})")
                continue
            results[kernel][label] = ms
            log(f"{kernel:16s} {label:26s}: {ms:9.4f} ms (error {err:.2e})")
    for kernel, times in results.items():
        ok = {k: v for k, v in times.items() if v is not None}
        best = min(ok, key=ok.get)
        log(f"best {kernel}: {best} ({ok[best]:.4f} ms; default "
            f"{ok['default']:.4f} ms)")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m msda_tpu_torch.autotune",
        description="Sweep the CUDA kernels' compile-time launch constants "
                    "on the card; print each candidate's ms and the best.")
    ap.add_argument("--stream", action="store_true",
                    help="sweep the streamed kernels' constants (STREAM_"
                         "SLICE, FWD_/BWD_CHUNKS_PER_BLOCK) at the 256-base "
                         "pyramid instead of K1's MSDA_FWD_* and K2's "
                         "MSDA_BWD_*")
    ap.add_argument("--queries", type=int, default=10000)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=60,
                    help="launches a timed run (three runs, the median)")
    ap.add_argument("--per-constant", type=int, default=None,
                    help="the first K candidates of each constant (the "
                         "default among them); all by default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("autotune times the CUDA kernels: no card visible")
    smi = ", ".join(card_identity())
    print(f"# autotune{' --stream' if args.stream else ''} @ N="
          f"{args.queries}, {args.dtype}, {args.iters} launches a run, on "
          f"{smi}", flush=True)
    return sweep(args.stream, args.queries, getattr(torch, args.dtype),
                 args.iters, args.per_constant,
                 log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
