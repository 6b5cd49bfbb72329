"""Wrapper of the auction's large-N path in ``csrc/msda_auction.cu``.

The auction kernel (``cuda_matcher``) keeps an image's per-query state in a
block's shared memory, which holds N + M <= ``cuda_matcher.MAX_SLOTS``.
Two-stage Deformable DETR matches its targets over every encoder token, N =
22,223 proposals an image at 800x1333.  This path solves the same auction
over the union of each active target's ``candidates(A)`` cheapest queries
(A the image's active targets; at most ``slots(M)`` queries), which gives
the assignment over all N exactly (the note at the top of the source says
why): a select kernel and a compaction kernel build the smaller problem,
and the auction kernel solves it, all on the card, with nothing read back
to the host (a transpose kernel first lays each image's costs out by
target).  It gives the indices and ``converged`` of its plain version,
``matcher.plain_auction`` over the whole cost.

The wrapper checks what ``cuda_matcher.auction`` checks, allows any N past
``M + 2``, and raises on M(M + 2) + M > ``MAX_SLOTS`` (M > 108); it never
falls back to the plain version.  Each call adds one to ``LAUNCHES`` (one
call is four kernel launches).
"""

from __future__ import annotations

import torch

from ..ops import launches
from . import cuda_matcher

__all__ = ["KERNEL", "LAUNCHES", "auction", "candidates", "slots"]

KERNEL = "msda_auction_large"
_INT32_MAX = 2**31 - 1

# Number of calls of the path since import (or since a caller reset it).
LAUNCHES = 0
launches.register(__name__)


def candidates(A: int) -> int:
    """The cheapest queries kept for each of an image's A active targets:
    A + 2, so that at least two of them are unpriced whatever the A owned
    queries are."""
    return A + 2


def slots(M: int) -> int:
    """The smaller problem's queries at most: every target's candidates,
    all M active."""
    return M * candidates(M)


def auction(cost: torch.Tensor, active: torch.Tensor | None = None,
            eps: float = 1e-3, max_rounds: int = 2000):
    """The auction over ``cost`` ``[B, N, M]`` f32 (contiguous, on a CUDA
    device, N >= M + 2) through the large-N path, on
    ``torch.cuda.current_stream()``; ``active`` as in
    ``cuda_matcher.auction``.  Returns ``(query_idx [B, M] int64,
    converged [B] bool, rounds [B] int32)``, as that function does.
    Raises ``ValueError`` on inputs the path does not take and
    ``RuntimeError`` when the build or the launch fails."""
    global LAUNCHES
    eps, max_rounds = cuda_matcher.check_inputs(cost, active, eps,
                                                max_rounds)
    B, N, M = cost.shape
    S = slots(M)
    if B * M == 0:
        return cuda_matcher.no_targets(cost)
    if (N < candidates(M) or S + M > cuda_matcher.MAX_SLOTS or B > 65_535
            or B * N * M > _INT32_MAX):
        raise ValueError(
            f"the large-N path takes N >= M + 2, M * (M + 2) + M <= "
            f"{cuda_matcher.MAX_SLOTS}, B <= 65535 and B * N * M < 2**31, "
            f"got B, N, M = {B}, {N}, {M}")
    lib = cuda_matcher.load()
    device = cost.device
    cost_mn = torch.empty((B, M, N), dtype=torch.float32, device=device)
    member = torch.empty((B, N), dtype=torch.uint8, device=device)
    reduced = torch.empty((B, M, S), dtype=torch.float32, device=device)
    ids = torch.empty((B, S), dtype=torch.int32, device=device)
    counts = torch.empty((B,), dtype=torch.int32, device=device)
    fallback = torch.empty((B, M), dtype=torch.int32, device=device)
    query_idx = torch.empty((B, M), dtype=torch.int64, device=device)
    converged = torch.empty((B,), dtype=torch.bool, device=device)
    rounds = torch.empty((B,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES += 1
        err = lib.msda_auction_large_launch(
            cost.data_ptr(), None if active is None else active.data_ptr(),
            B, N, M, eps, max_rounds, cost_mn.data_ptr(), member.data_ptr(),
            reduced.data_ptr(), ids.data_ptr(), counts.data_ptr(),
            fallback.data_ptr(), query_idx.data_ptr(), converged.data_ptr(),
            rounds.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"msda_auction_large_launch failed: CUDA error {err}")
    return query_idx, converged, rounds
