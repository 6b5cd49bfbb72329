"""``msda_tpu_torch.utils.bench.msda_bound`` and ``touched_rows``: the
least time an H100 could take for one MSDA call, which ``chip_smoke.py``
prints beside every kernel's time.

The bytes are counted by hand below for Deformable DETR's encoder and
decoder shapes (B=2, H=8, C=32, L=4, P=4 on the 100x167 / 50x84 / 25x42 /
13x21 pyramid, I = 22,223 pixels; N = I and N = 300) and the 256-base
pyramid (B=4, N=10,000, I = 87,040).  Points and weights (and their
gradients) are f32; img, out, out_grad and img_grad are in the dtype.
"""

import pytest
import torch

from msda_tpu_torch.ops import native_msda_backward
from msda_tpu_torch.utils import msda_bound, roofline_ms, touched_rows
from msda_tpu_torch.utils.bench import H100_BYTES_PER_S, H100_F32_FLOPS
from utils import get_functional_data

DETR = ((100, 167), (50, 84), (25, 42), (13, 21))
BIG = ((256, 256), (128, 128), (64, 64), (32, 32))
F32, BF16 = torch.float32, torch.bfloat16

# encoder: 355,568 pixel rows (2 x 22,223 x 8) and as many query rows,
# 5,689,088 points; img / out / out_grad / img_grad 45,512,704 B in f32,
# points 45,512,704 B, weights 22,756,352 B.
# decoder: the same img, 4,800 query rows, 76,800 points (614,400 B of
# points, 307,200 of weights, 614,400 of out in f32).
# 256-base: 2,785,280 pixel rows (356,515,840 B of f32 img), 320,000 query
# rows (40,960,000 B of f32 out), 5,120,000 points (40,960,000 B, weights
# 20,480,000 B).
CASES = [
    # shapes, N, B, dtype, backward, bytes
    (DETR, 22223, 2, F32, False, 3 * 45_512_704 + 22_756_352),
    (DETR, 22223, 2, F32, True, 5 * 45_512_704 + 2 * 22_756_352),
    (DETR, 22223, 2, BF16, False, 2 * 22_756_352 + 45_512_704 + 22_756_352),
    (DETR, 22223, 2, BF16, True,
     3 * 22_756_352 + 2 * 45_512_704 + 2 * 22_756_352),
    (DETR, 300, 2, F32, False, 45_512_704 + 614_400 + 307_200 + 614_400),
    (DETR, 300, 2, F32, True,
     2 * 45_512_704 + 3 * 614_400 + 2 * 307_200),
    (DETR, 300, 2, BF16, False, 22_756_352 + 614_400 + 307_200 + 307_200),
    (DETR, 300, 2, BF16, True,
     2 * 22_756_352 + 2 * 614_400 + 2 * 307_200 + 307_200),
    (BIG, 10000, 4, F32, False,
     356_515_840 + 40_960_000 + 20_480_000 + 40_960_000),
    (BIG, 10000, 4, F32, True,
     2 * 356_515_840 + 3 * 40_960_000 + 2 * 20_480_000),
    (BIG, 10000, 4, BF16, False,
     178_257_920 + 40_960_000 + 20_480_000 + 20_480_000),
    (BIG, 10000, 4, BF16, True,
     2 * 178_257_920 + 2 * 40_960_000 + 2 * 20_480_000 + 20_480_000),
]


@pytest.mark.parametrize("shapes,N,B,dtype,backward,nbytes", CASES)
def test_msda_bound_counts_the_bytes_by_hand(shapes, N, B, dtype, backward,
                                             nbytes):
    got = msda_bound(shapes, B, N, 8, 32, 4, dtype, backward)
    points = B * N * 8 * 4 * 4
    # per point: 18 (geometry, weights) + 32 channels x 8 forward; the
    # backward 18 + 21 + 4 + 32 x 16 (four corner dot products, four
    # img_grad terms)
    flops = points * (32 * 16 + 43 if backward else 32 * 8 + 18)
    assert got["bytes"] == nbytes
    assert got["flops"] == flops
    t_bytes = nbytes / 3.35e12 * 1e3
    t_flops = flops / 67e12 * 1e3
    assert got["ms"] == pytest.approx(max(t_bytes, t_flops), rel=1e-12)
    assert got["bound_by"] == ("bytes" if t_bytes >= t_flops
                               else "operations")


def test_msda_bound_of_the_encoder():
    """The numbers the kernel table of PERF.md stands on: the f32 encoder
    moves 159.3 / 273.1 MB (47.5 / 81.5 us at 3.35 TB/s); the bf16
    backward's 204.8 MB (61.1 us) outweigh its 3.16 GFLOP (47.1 us at 67
    TFLOP/s)."""
    fwd = msda_bound(DETR, 2, 22223, 8, 32, 4)
    bwd = msda_bound(DETR, 2, 22223, 8, 32, 4, backward=True)
    bwd16 = msda_bound(DETR, 2, 22223, 8, 32, 4, BF16, backward=True)
    assert fwd["ms"] == pytest.approx(0.04755, abs=1e-5)
    assert bwd["ms"] == pytest.approx(0.08152, abs=1e-5)
    assert (fwd["bound_by"], bwd["bound_by"]) == ("bytes", "bytes")
    assert bwd16["bound_by"] == "bytes"
    assert bwd16["ms"] == pytest.approx(0.06114, abs=1e-5)
    assert bwd16["flops"] == 3_157_443_840


def test_msda_bound_counts_img_in_the_rows_read():
    """img is read in the rows the points reach; img_grad is written
    whole."""
    full = msda_bound(DETR, 2, 300, 8, 32, 4, backward=True)
    part = msda_bound(DETR, 2, 300, 8, 32, 4, backward=True, img_rows=1000)
    assert full["bytes"] - part["bytes"] == (2 * 22223 * 8 - 1000) * 32 * 4
    fwd = msda_bound(DETR, 2, 300, 8, 32, 4, img_rows=0)
    assert fwd["bytes"] == 614_400 + 307_200 + 614_400


def test_roofline_ms_takes_the_larger_time():
    assert roofline_ms(H100_BYTES_PER_S, 0) == (1e3, "bytes")
    assert roofline_ms(1.0, 2 * H100_F32_FLOPS) == (2e3, "operations")


def _point(x, y):
    return torch.tensor([x, y], dtype=torch.float32).view(1, 1, 1, 1, 1, 2)


@pytest.mark.parametrize("x,y,padding_mode,rows", [
    ((1 + 0.5) / 4, (2 + 0.5) / 4, "border", 1),    # a pixel centre
    (0.3, 0.4, "border", 4),                       # between four pixels
    ((1 + 0.5) / 4, 0.4, "border", 2),             # on a column
    (-0.2, 0.4, "border", 2),                      # left of the level
    (-0.2, 0.4, "zeros", 0),                       # outside: no weight
    (0.02, 0.4, "zeros", 2),                       # half outside
])
def test_touched_rows_of_one_point(x, y, padding_mode, rows):
    got = touched_rows(((4, 4),), _point(x, y), torch.ones(1, 1, 1, 1, 1),
                       padding_mode)
    assert got == rows


def test_touched_rows_skips_points_of_zero_weight():
    assert touched_rows(((4, 4),), _point(0.3, 0.4),
                        torch.zeros(1, 1, 1, 1, 1)) == 0


@pytest.mark.parametrize("padding_mode,align_corners",
                         [("border", False), ("zeros", True)])
def test_touched_rows_are_the_rows_with_a_gradient(padding_mode,
                                                   align_corners):
    """With positive weights and out_grad, a row's img_grad is a sum of
    positive terms: it is non-zero exactly on the rows the points reach."""
    img, shapes, pts, wts, _ = get_functional_data(N=7, P=2, oob=True,
                                                   seed=3)
    img, pts, wts = (torch.from_numpy(a) for a in (img, pts, wts))
    og = torch.ones(img.shape[0], pts.shape[1], img.shape[2], img.shape[3])
    grad = native_msda_backward(img, shapes, pts, wts, og, padding_mode,
                                align_corners)[0]
    want = int((grad.abs().sum(-1) > 0).sum())
    assert 0 < want < img.shape[0] * img.shape[1] * img.shape[2]
    assert touched_rows(shapes, pts, wts, padding_mode,
                        align_corners) == want
