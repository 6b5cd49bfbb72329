"""The least time an H100 could take for the auction's large-N path (the
published two-stage proposal matching over every encoder token): its cost
``[B, N, M]`` in f32 read once from device memory.  What it writes (the
transposed copy, the candidates, the smaller problem of M(M + 2) queries)
and its rounds are the design's, not the problem's, and are not
counted."""

from __future__ import annotations

from .peaks import BYTES_PER_S


def large_auction_bound_s(B: int, N: int, M: int) -> float:
    return B * N * M * 4 / BYTES_PER_S
