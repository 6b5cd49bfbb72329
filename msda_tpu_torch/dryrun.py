"""Multi-device dry run: one sharded training step of a tiny Deformable DETR
on an n-rank ("dp", "sp", "tp") mesh (the counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip``).

    python -m msda_tpu_torch.dryrun --devices 8 [--device cpu|cuda]

starts n ranks, one process each (gloo on the CPU; NCCL with one card a
rank on CUDA), factors n into (dp, sp, tp) as the JAX dry run does, places
the parameters with ``shard_params`` (the attention projections cut over
tp), runs one Adam step through ``make_train_step(mesh=...)`` and prints

    dryrun_multichip(n): mesh dp=.. sp=.. tp=.., one train step OK, loss=..

A watchdog bounds the run; it exits non-zero when any rank fails.
:func:`run_ranks` is the launcher.
"""

from __future__ import annotations

import argparse
import multiprocessing.connection
import os
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks", "main"]

SHAPES = ((16, 16), (8, 8), (4, 4), (2, 2))
CHANNELS = 32


def factor(n: int) -> tuple[int, int, int]:
    """(dp, sp, tp) of n ranks: tp 2 when n is even, sp 2 when 4 divides n,
    dp the rest (the JAX dry run's factoring)."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    return n // (tp * sp), sp, tp


def tiny_model(mesh=None, device=None):
    """The JAX dry run's model: 8 classes, emb 64, 4 heads, 2 points, 16
    queries, one encoder and one decoder layer, ffn 128, over 4 levels of
    32 channels."""
    from .models import DeformableDetr

    return DeformableDetr(
        num_classes=8, in_channels=(CHANNELS,) * len(SHAPES), emb_dim=64,
        num_heads=4, num_points=2, num_queries=16, num_encoder_layers=1,
        num_decoder_layers=1, ffn_dim=128, device=device, mesh=mesh)


def _rank_main(fn, rank, n, init_method, device, timeout, args):
    """One rank: join the process group, run ``fn(rank, n, device,
    *args)``, leave it."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init_method, world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout))
    try:
        fn(rank, n, device, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args, device: str = "cpu",
              timeout: float = 600.0) -> None:
    """Run ``fn(rank, n, device, *args)`` in ``n`` fresh processes, each
    rank of one process group (gloo on the CPU, NCCL on CUDA, one card a
    rank), joined through a file store of its own, so that runs side by
    side never meet.  ``fn`` must be importable by name (a module-level
    function).  Raises ``RuntimeError`` when a rank fails (the others are
    stopped at once) or when the ranks have not finished in ``timeout``
    seconds; each rank's error goes to its standard error."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks on CUDA need {n} cards, "
                           f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="msda_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, init, device, timeout, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"the {n} ranks did not finish in "
                                       f"{timeout:g} s")
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    break
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.is_alive()],
                    timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}")


def _dryrun_rank(rank, n, device):
    from .models import init_parameters
    from .parallel import make_mesh, make_train_step, shard_params

    dp, sp, tp = factor(n)
    dev = torch.device(device, rank) if device == "cuda" else torch.device(
        device)
    mesh = make_mesh({"dp": dp, "sp": sp, "tp": tp}, device_type=device)
    model = init_parameters(tiny_model(mesh, dev),
                            torch.Generator().manual_seed(0))
    shard_params(model, mesh)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_train_step(model, optimizer, SHAPES, mesh=mesh)

    # the global batch, the same on every rank; each takes its dp block
    rng = np.random.default_rng(0)
    batch = 2 * dp
    pyramid = [rng.standard_normal((batch, h, w, CHANNELS), dtype=np.float32)
               for h, w in SHAPES]
    targets = {
        "labels": rng.integers(0, 8, (batch, 16)),
        "boxes": rng.random((batch, 16, 4), dtype=np.float32),
        "mask": np.ones((batch, 16), np.float32),
    }
    d = mesh.get_local_rank("dp")

    def local(a):
        return torch.from_numpy(a[2 * d:2 * d + 2]).to(dev)

    loss = step([local(f) for f in pyramid],
                {k: local(v) for k, v in targets.items()}).item()
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if rank == 0:
        print(f"dryrun_multichip({n}): mesh dp={dp} sp={sp} tp={tp}, "
              f"one train step OK, loss={loss:.4f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m msda_tpu_torch.dryrun",
        description="One sharded training step of a tiny Deformable DETR "
                    "on an n-rank (dp, sp, tp) mesh.")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks, one process each (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card a rank; cpu: gloo")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="watchdog, in seconds (default 600)")
    args = ap.parse_args(argv)
    run_ranks(_dryrun_rank, args.devices, device=args.device,
              timeout=args.timeout)


if __name__ == "__main__":
    main()
