"""Tiny stand-ins of the benchmark's configurations and mixes, so that a
whole run (set-up, window, check) fits a CPU test."""

from __future__ import annotations

import copy
import tempfile
import time

import torch

from perfbench import harness

DETECTOR = {"emb_dim": 32, "num_heads": 2, "head_dim": 16, "num_levels": 2,
            "num_points": 2, "num_encoder_layers": 1,
            "num_decoder_layers": 2, "ffn_dim": 64, "num_queries": 12,
            "num_classes": 5, "in_channels": [8, 16], "strides": [8, 16]}
SERVE = {"sizes": [[32, 48], [48, 32]], "pool_per_size": 1, "top_k": 10}
TRAIN = {"size": [32, 48], "target_slots": 6, "real_targets": [2, 3]}
OP = {"num_heads": 2, "head_dim": 8, "num_levels": 2, "num_points": 2,
      "strides": [8, 16]}
OP_TRAFFIC = {"size": [32, 48], "pool": 2, "checked_calls": 2}


def shrink(cell):
    """``cell`` (``harness.find_cell``) with its configuration and traffic
    cut to a tiny size; everything else as it is."""
    cell = copy.copy(cell)
    cell.config, cell.traffic = dict(cell.config), dict(cell.traffic)
    driver = cell.traffic["driver"]
    if driver == "op":
        cell.config.update(OP)
        cell.traffic.update(OP_TRAFFIC)
    else:
        cell.config.update(DETECTOR)
        cell.traffic.update(SERVE if driver == "serve" else TRAIN)
    return cell


def run(name: str, trace: bool = False, seconds: float = 0.5,
        seed: int = 2 ** 31 + 12345, root=harness.ROOT) -> dict:
    """A whole run of the cell ``name`` at the tiny size on the CPU (the
    look for a card skipped): the result line's fields."""
    cell = shrink(harness.find_cell(root, name))
    with tempfile.TemporaryDirectory() as tmpdir:
        return harness.execute(cell, seed, seconds, trace,
                               torch.device("cpu"), time.perf_counter(),
                               tmpdir)
