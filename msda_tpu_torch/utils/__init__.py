"""Benchmark utilities (the counterpart of ``msda_tpu/utils``)."""

from .bench import device_memory_stats, reference_workload, timeit_op

__all__ = ["timeit_op", "device_memory_stats", "reference_workload"]
