"""msda_tpu_torch — PyTorch / CUDA port of ``msda_tpu``.

The same public surface as the JAX package, in PyTorch: the functional
multiscale deformable attention op (Deformable DETR, arXiv:2010.04159), its
plain gather-based version, and the attention module.  On an NVIDIA Hopper
card the op runs hand-written CUDA kernels: the forward
(``csrc/msda_fwd.cu``) and the backward (``csrc/msda_bwd.cu``), and for a
pyramid that outgrows the card's L2 the streamed forward and backward
(``csrc/msda_stream.cu``, routed by ``ops/stream.py``).  On CPU tensors it
runs the plain version.

Public API (the names of ``msda_tpu/__init__.py``):
    multiscale_deformable_attention        — functional op, impl dispatch
    native_multiscale_deformable_attention — plain gather-based version
    compute_level_data                     — per-level heights/widths/offsets
    MultiscaleDeformableAttention          — nn.Module with projections
"""

from ._version import __version__
from .models import MultiscaleDeformableAttention
from .ops import (
    compute_level_data,
    multiscale_deformable_attention,
    native_multiscale_deformable_attention,
)

__all__ = [
    "multiscale_deformable_attention",
    "native_multiscale_deformable_attention",
    "compute_level_data",
    "MultiscaleDeformableAttention",
    "__version__",
]
