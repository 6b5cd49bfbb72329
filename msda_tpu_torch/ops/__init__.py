"""Operator library: the multiscale deformable attention op and its kernels.

``library`` registers the operators ``torch.ops.msda_tpu_torch.msda_fwd``
and ``msda_bwd`` when this package is imported.  ``cuda_fwd``, ``cuda_bwd``
and ``cuda_stream`` (the CUDA kernels' wrappers) are imported lazily, at
the operators' first CUDA call, and build their kernels at first use, so
that this package imports on machines without a GPU or ``nvcc``.
``library`` also registers ``add_layer_norm``, the detector's residual add
+ LayerNorm, and imports its wrapper ``cuda_norm`` (whose plain version is
the operator's CPU implementation); it too builds its kernel at first use.  ``stream`` holds the large-pyramid path's band plan, L2
router and plain streamed versions.
"""

from .msda import multiscale_deformable_attention, resolved_impl
from .reference import (
    compute_level_data,
    level_shapes,
    native_msda_backward,
    native_multiscale_deformable_attention,
)

__all__ = [
    "multiscale_deformable_attention",
    "resolved_impl",
    "native_multiscale_deformable_attention",
    "native_msda_backward",
    "compute_level_data",
    "level_shapes",
]
