"""The frozen yardstick against hand counts at tiny shapes: the MSDA
bound's bytes and operations, the rows the points touch, the detector's
operations, and the trace reader's arithmetic."""

from __future__ import annotations

import itertools
import json

import pytest
import torch

from perfbench.arith import bound, flops, peaks
from perfbench.tracefile import TraceFile

import tiny


def test_bound_forward_and_backward_by_hand():
    shapes = ((2, 3), (1, 2))  # I = 8
    B, N, H, C, P = 2, 5, 3, 4, 2
    points = B * N * H * 2 * P  # 120
    fwd = bound.msda_bound(shapes, B, N, H, C, P)
    img = B * 8 * H * C * 4
    small = points * 2 * 4 + points * 4  # points and weights, f32
    out = B * N * H * C * 4
    assert fwd["bytes"] == img + small + out
    assert fwd["flops"] == points * (8 * C + 18)
    bwd = bound.msda_bound(shapes, B, N, H, C, P, backward=True, img_rows=7)
    assert bwd["bytes"] == 7 * C * 4 + small + out + img + small
    assert bwd["flops"] == points * (16 * C + 43)
    assert fwd["ms"] == pytest.approx(max(
        fwd["bytes"] / peaks.BYTES_PER_S, fwd["flops"] / peaks.F32_FLOPS)
        * 1e3)


def _touched_by_hand(shapes, pts, wts):
    """Every (b, pixel, h) row a corner with a non-zero weight reads,
    point by point."""
    rows = set()
    B, N, H, L, P, _ = pts.shape
    start = list(itertools.accumulate([0] + [h * w for h, w in shapes]))
    for b, n, h, lvl, p in itertools.product(*map(range, (B, N, H, L, P))):
        hh, ww = shapes[lvl]
        x = float(pts[b, n, h, lvl, p, 0]) * ww - 0.5
        y = float(pts[b, n, h, lvl, p, 1]) * hh - 0.5
        x0, y0 = int(torch.floor(torch.tensor(x))), int(
            torch.floor(torch.tensor(y)))
        fx, fy = x - x0, y - y0
        for cy, cx, w in ((y0, x0, (1 - fy) * (1 - fx)),
                          (y0, x0 + 1, (1 - fy) * fx),
                          (y0 + 1, x0, fy * (1 - fx)),
                          (y0 + 1, x0 + 1, fy * fx)):
            if w * float(wts[b, n, h, lvl, p]) == 0:
                continue
            cy, cx = min(max(cy, 0), hh - 1), min(max(cx, 0), ww - 1)
            rows.add((b, start[lvl] + cy * ww + cx, h))
    return len(rows)


def test_touched_rows_by_hand():
    g = torch.Generator().manual_seed(5)
    shapes = ((4, 5), (2, 3))
    pts = torch.rand((2, 6, 2, 2, 3, 2), generator=g) * 1.2 - 0.1
    pts[0, 0, 0, 0, 0] = torch.tensor([0.3, 0.625])  # on a pixel centre
    wts = torch.rand((2, 6, 2, 2, 3), generator=g)
    wts[1, 2] = 0.0  # a query whose weights are all zero touches nothing
    assert bound.touched_rows(shapes, pts, wts) == _touched_by_hand(
        shapes, pts, wts)


def test_detector_flops_by_hand():
    path = tiny.harness.ROOT / "perfbench" / "configs" / "ddetr-refine.json"
    cfg = dict(json.loads(path.read_text()), **tiny.DETECTOR)
    B, hw = 2, (32, 48)
    # levels (4, 6) and (2, 3): I = 30; D 32, F 64, Q 12, K 5, H 2, L 2, P 2
    I, D, F, Q, K, H, L, P = 30, 32, 64, 12, 5, 2, 2, 2  # noqa: E741
    C = D // H
    inproj = 2 * B * (24 * 8 + 6 * 16) * D

    def msda(n):
        return (2 * B * I * D * D + 2 * B * n * D * H * L * P * 3
                + B * n * H * L * P * (8 * C + 18) + 2 * B * n * D * D)

    ffn = 2 * 2 * D * F
    enc = 1 * (msda(I) + B * I * ffn)
    dec = 2 * (4 * 2 * B * Q * D * D + 2 * 2 * B * H * Q * Q * C + msda(Q)
               + B * Q * ffn)
    heads = 2 * (2 * B * Q * D * K + 2 * B * Q * D * 4)
    assert flops.detector_forward_flops(cfg, B, hw) == inproj + enc + dec \
        + heads


def test_trace_arithmetic(tmp_path):
    """Busy time is the union of device intervals; device time goes to
    the span that launched it through the correlation id; host time
    outside the CUDA API; gaps labelled by the host's innermost event."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.unit",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.fwd",
         "ts": 0, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.bwd",
         "ts": 50, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 5, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 60, "dur": 20, "tid": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 105,
         "dur": 90, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30,
         "tid": 7, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 30,
         "tid": 7, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 200, "dur": 10,
         "tid": 7, "args": {"correlation": 99}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = TraceFile(str(path))
    assert t.busy_s() == pytest.approx(60e-6)  # [20, 70] and [200, 210]
    got = t.span_device_s({"perfbench.fwd", "perfbench.bwd"})
    assert got == pytest.approx({"perfbench.fwd": 30e-6,
                                 "perfbench.bwd": 30e-6, None: 10e-6})
    # both threads' API calls lie inside the span: 5 + 20 us
    assert t.host_outside_api_s("perfbench.unit") == pytest.approx([75e-6])
    assert t.device_ops(2) == [["k1", pytest.approx(30e-6)],
                               ["k2", pytest.approx(30e-6)]]
    assert t.idle_gaps() == [["aten::add", pytest.approx(130e-6)]]
