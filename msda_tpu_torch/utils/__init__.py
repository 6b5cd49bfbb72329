"""Benchmark, export, CUDA graph and profiling utilities (the counterpart of
``msda_tpu/utils``)."""

from .bench import (card_identity, device_memory_stats, msda_bound,
                    reference_workload, roofline_ms, timeit_op, touched_rows)
from .export import export_fn, load_exported, load_exported_file, save_exported
from .graphs import graphed
from .profile import annotate, trace

__all__ = ["timeit_op", "device_memory_stats", "card_identity",
           "reference_workload",
           "msda_bound", "roofline_ms", "touched_rows", "export_fn",
           "load_exported", "save_exported", "load_exported_file", "graphed",
           "trace", "annotate"]
