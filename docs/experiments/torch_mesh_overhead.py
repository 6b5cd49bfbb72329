#!/usr/bin/env python3
"""Host cost of the attention module's mesh path, on the CPU.

    python3 docs/experiments/torch_mesh_overhead.py [--calls 1000]

One process, a one-rank gloo group and a ("dp", "sp", "tp") mesh of size
1: ``msda_tpu_torch.MultiscaleDeformableAttention`` at a tiny size (the
op's own work is a few microseconds, so the time a call is the host's),
without a mesh, with the mesh (its local blocks go straight to the op),
and the op alone through ``shard_map_multiscale_deformable_attention`` on
the same blocks wrapped as DTensors (``local_map`` with its placements,
the path the module took before it passed local blocks).  Prints µs a
call of each, the mean of ``--calls`` after a warm-up.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from msda_tpu_torch.models import MultiscaleDeformableAttention  # noqa: E402
from msda_tpu_torch.ops import multiscale_deformable_attention  # noqa: E402
from msda_tpu_torch.parallel import make_mesh  # noqa: E402
from msda_tpu_torch.parallel.sharding import (  # noqa: E402
    MSDA_SHARDINGS, placements, shard_map_multiscale_deformable_attention)


def per_call_us(fn, calls: int) -> float:
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    from torch.distributed.tensor import DTensor

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device_type="cpu")
            torch.manual_seed(0)
            plain = MultiscaleDeformableAttention(8, 8, 1, 2, 1)
            meshed = MultiscaleDeformableAttention(8, 8, 1, 2, 1, mesh=mesh)
            meshed.load_state_dict(plain.state_dict())
            img, queries = torch.randn(1, 4, 8), torch.randn(1, 2, 8)
            refs, shapes = torch.rand(1, 2, 2), [(2, 2)]
            blocks = (torch.randn(1, 4, 2, 4), torch.rand(1, 2, 2, 1, 1, 2),
                      torch.rand(1, 2, 2, 1, 1))
            wrapped = [DTensor.from_local(t, mesh, placements(
                mesh, MSDA_SHARDINGS[name]), run_check=False)
                for t, name in zip(blocks, ("img", "sampling_points",
                                            "attention_weights"))]
            rows = {
                "module, no mesh": lambda: plain(img, shapes, queries, refs),
                "module, one-rank mesh": lambda: meshed(img, shapes, queries,
                                                        refs),
                "op on local blocks": lambda: multiscale_deformable_attention(
                    blocks[0], shapes, *blocks[1:]),
                "op through local_map (DTensors)":
                    lambda: shard_map_multiscale_deformable_attention(
                        mesh, wrapped[0], shapes, *wrapped[1:]),
            }
            for name, fn in rows.items():
                print(f"{name:34s} {per_call_us(fn, args.calls):9.1f} µs a "
                      f"call (CPU, {torch.get_num_threads()} threads)")
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
