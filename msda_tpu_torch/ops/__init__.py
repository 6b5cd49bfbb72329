"""Operator library: the multiscale deformable attention op and its kernels.

``cuda_fwd``, ``cuda_bwd`` and ``cuda_stream`` (the CUDA kernels'
wrappers) are imported lazily, at the first ``impl="cuda"`` call, and build
their kernels at first use, so that this package imports on machines without
a GPU or ``nvcc``.  ``stream`` holds the large-pyramid path's band plan, L2
router and plain streamed versions.
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
