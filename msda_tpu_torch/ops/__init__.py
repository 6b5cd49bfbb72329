"""Operator library: the multiscale deformable attention op and its kernels.

``cuda_fwd`` (the CUDA kernel's wrapper) is imported lazily, at the first
``impl="cuda"`` call, so that this package imports on machines without a
GPU or ``nvcc``.
"""

from .msda import multiscale_deformable_attention
from .reference import (
    compute_level_data,
    level_shapes,
    native_multiscale_deformable_attention,
)

__all__ = [
    "multiscale_deformable_attention",
    "native_multiscale_deformable_attention",
    "compute_level_data",
    "level_shapes",
]
