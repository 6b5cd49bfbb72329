"""Wrapper of the CUDA auction kernel in ``csrc/msda_auction.cu``.

The kernel has no Pallas original: it is the counterpart of the XLA
``lax.while_loop`` of ``msda_tpu/parallel/matcher.py:_auction_phase``
(with ``auction_assignment``'s argmin fallback and ``converged`` flag),
which JAX runs on the device inside the jitted train step.  One launch runs
every bidding round of every image, a block per image, and reads nothing
back to the host (see the note at the top of the source for its design and
what bounds it).  Its plain version is ``matcher.plain_auction``, the
batched loop of rounds, which gives the same indices exactly.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; it never falls back to the plain
version.  The library is built at first use (``ops._build.load_library``),
and each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import _build, launches

__all__ = ["KERNEL", "LAUNCHES", "MAX_SLOTS", "auction",
           "check_inputs", "load", "no_targets"]

KERNEL = "msda_auction"
# queries + targets at most: their per-slot state (16 bytes each) must fit
# in a block's shared memory beside nothing else (227 KB on an H100)
MAX_SLOTS = 12_288
_INT32_MAX = 2**31 - 1

# Number of kernel launches since import (or since a caller reset it).
LAUNCHES = 0
launches.register(__name__)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; set the signatures
    of its entry points (this kernel's, and the large-N path's of
    ``cuda_auction_large``)."""
    lib = _build.load_library(KERNEL)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.msda_auction_launch.argtypes = [vp, vp, ci, ci, ci, cf, ci, vp, vp,
                                        vp, vp]
    lib.msda_auction_launch.restype = ci
    lib.msda_auction_large_launch.argtypes = [vp, vp, ci, ci, ci, cf, ci,
                                              *[vp] * 10]
    lib.msda_auction_large_launch.restype = ci
    return lib


def check_inputs(cost: torch.Tensor, active: torch.Tensor | None, eps,
                 max_rounds) -> tuple[float, int]:
    """Raise ``ValueError`` unless ``cost`` is ``[B, N, M]`` f32 (N >= M),
    contiguous, on a CUDA device, ``active`` None or ``[B, M]`` bool,
    contiguous, on its device, and ``max_rounds`` a 32-bit int; return
    ``eps`` and ``max_rounds`` as a launch takes them."""
    if not cost.is_cuda:
        raise ValueError(f"the CUDA auction kernel needs a CUDA cost, got "
                         f"one on {cost.device}")
    if cost.dtype != torch.float32 or cost.ndim != 3:
        raise ValueError(f"cost must be [B, N, M] f32, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous")
    B, N, M = cost.shape
    if M > N:
        raise ValueError(f"more targets ({M}) than queries ({N})")
    if active is not None:
        if (active.dtype != torch.bool or tuple(active.shape) != (B, M)
                or active.device != cost.device
                or not active.is_contiguous()):
            raise ValueError(
                f"active must be a contiguous [B, M] = {(B, M)} bool tensor "
                f"on {cost.device}, got {tuple(active.shape)} "
                f"{active.dtype} on {active.device}")
    max_rounds = int(max_rounds)
    if not -_INT32_MAX <= max_rounds <= _INT32_MAX:
        raise ValueError(f"max_rounds out of range: {max_rounds}")
    return float(eps), max_rounds


def no_targets(cost: torch.Tensor):
    """What the auction returns without a target: nothing to bid for, as
    in the JAX loop."""
    B, _, M = cost.shape
    return (torch.zeros((B, M), dtype=torch.int64, device=cost.device),
            torch.ones((B,), dtype=torch.bool, device=cost.device),
            torch.zeros((B,), dtype=torch.int32, device=cost.device))


def auction(cost: torch.Tensor, active: torch.Tensor | None = None,
            eps: float = 1e-3, max_rounds: int = 2000):
    """Launch the auction kernel on ``torch.cuda.current_stream()``.

    ``cost`` is ``[B, N, M]`` f32, contiguous, on a CUDA device (N >= M);
    ``active`` is None (every target) or ``[B, M]`` bool on its device.
    Returns ``(query_idx [B, M] int64, converged [B] bool, rounds [B]
    int32)``: each target's query, whether every active target won one
    within ``max_rounds`` rounds, and the rounds each image took.  Raises
    ``ValueError`` on inputs the kernel does not take and ``RuntimeError``
    when the build or the launch fails.
    """
    global LAUNCHES
    eps, max_rounds = check_inputs(cost, active, eps, max_rounds)
    B, N, M = cost.shape
    if N + M > MAX_SLOTS or B * N * M > _INT32_MAX:
        raise ValueError(f"the kernel takes N + M <= {MAX_SLOTS} and "
                         f"B * N * M < 2**31, got B, N, M = {B}, {N}, {M} "
                         "(cuda_auction_large takes larger N)")
    if B * M == 0:
        return no_targets(cost)
    lib = load()
    query_idx = torch.empty((B, M), dtype=torch.int64, device=cost.device)
    converged = torch.empty((B,), dtype=torch.bool, device=cost.device)
    rounds = torch.empty((B,), dtype=torch.int32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES += 1
        err = lib.msda_auction_launch(
            cost.data_ptr(), None if active is None else active.data_ptr(),
            B, N, M, eps, max_rounds, query_idx.data_ptr(),
            converged.data_ptr(), rounds.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"msda_auction_launch failed: CUDA error {err}")
    return query_idx, converged, rounds
