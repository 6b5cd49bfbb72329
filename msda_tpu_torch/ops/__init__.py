"""Operator library: the multiscale deformable attention op and its kernels.

``cuda_fwd`` and ``cuda_bwd`` (the CUDA kernels' wrappers) are imported
lazily, at the first ``impl="cuda"`` call, so that this package imports on
machines without a GPU or ``nvcc``.
"""

from .msda import multiscale_deformable_attention
from .reference import (
    compute_level_data,
    level_shapes,
    native_msda_backward,
    native_multiscale_deformable_attention,
)

__all__ = [
    "multiscale_deformable_attention",
    "native_multiscale_deformable_attention",
    "native_msda_backward",
    "compute_level_data",
    "level_shapes",
]
