"""Wrapper of the CUDA residual add + LayerNorm kernel in
``csrc/msda_norm.cu``.

The kernel has no Pallas original: the JAX model leaves the post-norm
``nn.LayerNorm()(x + y)`` to XLA, which fuses it; the port ran it as four
kernels under bf16 (the add, an up-cast, ``F.layer_norm`` in f32 and a
down-cast).  The kernel computes the same function in one pass (see the
note at the top of the source for its design and what bounds it).  Its
plain version is that chain, ``add_layer_norm_plain``, which is also the
CPU implementation of the operator ``torch.ops.msda_tpu_torch.add_layer_norm``
(``library.py``).

The wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything the kernel does not take; it never falls back to the
plain version.  ``weight`` and ``bias`` are cast to f32 (a no-op for f32
master parameters).  The library is built at first use
(``_build.load_library``), and each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, launches

__all__ = ["KERNEL", "LAUNCHES", "MAX_DIM", "DTYPES", "DTYPE_CODES",
           "supported", "add_layer_norm", "add_layer_norm_plain", "load"]

KERNEL = "msda_norm"
MAX_DIM = 1024  # msda_add_layer_norm_max_dim() in the source
DTYPES = (torch.bfloat16, torch.float16)
DTYPE_CODES = {torch.float16: 1, torch.bfloat16: 2}  # as cuda_fwd's
_INT32_MAX = 2**31 - 1

# Number of kernel launches since import (or since a caller reset it).
LAUNCHES = 0
launches.register(__name__)


def supported(dim: int) -> bool:
    """Whether the kernel takes rows of ``dim`` elements: a multiple of 8,
    8 to ``MAX_DIM``."""
    return dim % 8 == 0 and 8 <= dim <= MAX_DIM


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; set its signature."""
    lib = _build.load_library(KERNEL)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.msda_add_layer_norm_launch.argtypes = [ci, vp, vp, vp, vp, vp, ci, ci,
                                               ctypes.c_float, vp]
    lib.msda_add_layer_norm_launch.restype = ci
    return lib


def add_layer_norm_plain(a: torch.Tensor, b: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """What the kernel computes, as the chain of PyTorch calls it replaces:
    ``a + b`` in ``a``'s dtype, layer-normalized over the last dimension in
    f32 with ``weight`` and ``bias`` in f32, cast back to ``a``'s dtype."""
    stat = torch.promote_types(a.dtype, torch.float32)
    y = F.layer_norm((a + b).to(stat), (a.shape[-1],), weight.to(stat),
                     bias.to(stat), eps)
    return y.to(a.dtype)


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def add_layer_norm(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on ``torch.cuda.current_stream()``: the LayerNorm
    of ``a + b`` over the last dimension, in ``a``'s dtype.

    ``a`` and ``b`` are bf16 or f16 of one shape ``[..., D]`` (D supported),
    contiguous and 16-byte aligned; ``weight`` and ``bias`` are ``[D]`` of
    any float dtype (cast to f32).  Raises ``ValueError`` on inputs the
    kernel does not take and ``RuntimeError`` when the build or the launch
    fails.
    """
    global LAUNCHES
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"the CUDA kernel takes a and b of one dtype, bf16 "
                         f"or f16, got {a.dtype} and {b.dtype}")
    w = weight.to(torch.float32).contiguous()
    c = bias.to(torch.float32).contiguous()
    tensors = (a, b, w, c)
    if not all(t.is_cuda for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError(
            "the CUDA kernel needs a, b, weight and bias on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}")
    if a.ndim < 1 or a.shape != b.shape:
        raise ValueError(f"a and b must have one shape [..., D], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    D = a.shape[-1]
    if not supported(D):
        raise ValueError(f"the kernel takes D a multiple of 8 from 8 to "
                         f"{MAX_DIM}, got {D}")
    if w.shape != (D,) or c.shape != (D,):
        raise ValueError(f"weight and bias must be [{D}], got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if not all(_aligned(t) for t in tensors):
        raise ValueError("a, b, weight and bias must be contiguous and "
                         "16-byte aligned")
    rows = a.numel() // D
    if rows > _INT32_MAX:
        raise ValueError("more than 2**31 - 1 rows are not supported")

    lib = load()
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if rows == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES += 1
        err = lib.msda_add_layer_norm_launch(
            DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), w.data_ptr(),
            c.data_ptr(), out.data_ptr(), rows, D, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"msda_add_layer_norm_launch failed: CUDA error "
                           f"{err}")
    return out
