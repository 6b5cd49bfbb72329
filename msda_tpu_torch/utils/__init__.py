"""Benchmark utilities (the counterpart of ``msda_tpu/utils``)."""

from .bench import (device_memory_stats, msda_bound, reference_workload,
                    roofline_ms, timeit_op, touched_rows)

__all__ = ["timeit_op", "device_memory_stats", "reference_workload",
           "msda_bound", "roofline_ms", "touched_rows"]
