"""The port's CUDA kernels (K1 forward, K2 backward, the streamed K3'
forward and K4' + K5' backward with their binning, and the auction
matcher) against their plain versions, and the train step and a serving
request captured as CUDA graphs against the eager step and request, on the
card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them:
the kernel has no CPU mode.  The file imports no JAX, so it runs on a
machine with the card and PyTorch only:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)

Tolerances, relative to max(1, |ref|): K1 f32 1e-5 (both sum in f32, in
different orders); bf16 2e-2 and f16 2e-3, about two ulps of the output type,
since both round an f32 sum once.  K2: the point and weight gradients 1e-4 in
every dtype (both compute the point gradients exactly, with f64 channel sums,
on the same f32 geometry; the weight gradients are f32 sums over channels, in
different orders); img_grad f32 1e-4 (f32 atomic sums in run-dependent
order), bf16 2e-2 and f16 2e-3 (both round an f32 sum once).  The streamed
kernels are held to the same tolerances against ``stream.plain_stream_fwd``
/ ``plain_stream_bwd``, and their binning exactly against
``stream.sample_bins``.

K1 and K2 serve a task with a group of lanes, 4 channels a lane where C and
the alignment allow it and 1 otherwise: the cases cover both (C = 30 and 6
take one channel a lane, as do img and out_grad views that start off a
16-byte boundary), groups of 8, 16 and 32 lanes (C = 32, 48, 128), L*P
that does not divide among a warp's tasks, and every query of a head on
the same pixels (the img_grad adds of whole warps on one row).  K2 sums
the img_grad terms of a query's consecutive points on the same pixels in
registers and adds a run of two or more exactly (``csrc/msda_bwd.cu``):
its cases add a 64-base pyramid with 21,847 queries, C = 32, 30, 24 and
160 (channel steps: no merging), and every point of each (b, h) at one
place on every level, where one f32 atomic a point missed the 1e-4 bar.
K1 walks tiles of T consecutive (b, h, n) tasks whose points arrive in
shared memory by asynchronous copies (``csrc/msda_fwd.cu``): its cases add
N of T - 1, T, T + 1 and 2T + 1 (T from ``cuda_fwd.launch_plan``), rows of
points that are not a multiple of 16 bytes (L * P = 3), 16 levels of one
and of four points (two chunks of points; at C = 160 two channel passes
too), 33 points a task at C = 30, points and weights off an 8-byte
boundary (4-byte copies) and a head of about 94 tiles.  K2 walks tiles of
T consecutive (b, n, h) tasks on the same pipeline: its cases add T - 1,
T, T + 1 and 2T + 1 tasks (T from ``cuda_bwd.launch_plan``), the same odd
rows and chunks (at C = 160 with channel steps), misaligned points and
weights, about 375 tiles of two heads, and the decoder's call (N = 300
against the encoder's 22,223 pixels: fewer tiles than the grid).
"""

from itertools import product

import numpy as np
import pytest
import torch

from msda_tpu_torch.models import DeformableDetr, init_parameters, postprocess
from msda_tpu_torch.ops import (
    level_shapes,
    multiscale_deformable_attention,
    native_msda_backward,
    native_multiscale_deformable_attention,
)
from msda_tpu_torch.ops import cuda_bwd, cuda_fwd, cuda_stream, library, stream
from msda_tpu_torch.parallel import (auction_assignment, cuda_matcher,
                                     detection_loss, make_train_step)
from msda_tpu_torch.parallel.matcher import plain_auction
from msda_tpu_torch.utils import graphed
from utils import get_functional_data

pytestmark = pytest.mark.cuda

MODES = list(product(["border", "zeros"], [False, True]))
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
IMG_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
                torch.float16: 2e-3}
POINT_GRAD_TOL = 1e-4
# The lane-group kernels serve a task with G lanes of 4 channels (1 where C
# or the alignment does not allow 4), 32 / G tasks per warp.
CFGS = [
    dict(N=130, P=3),          # ragged N, P not a power of two; G = 8
    dict(N=37, C=48, P=9),     # G * 4 = 64 past C; L*P = 36 past one warp
    dict(N=29, P=9),           # P crossing the 4 tasks of a warp
    dict(N=41, C=30, P=4),     # C not a multiple of 4: one channel a lane
    dict(N=50, C=6, P=2),      # one channel a lane, G = 8
    dict(N=23, C=128, P=3),    # G = 32: one task per warp
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, with_grad=False, **cfg):
    img, shapes, pts, wts, og = get_functional_data(oob=True, seed=5, **cfg)
    img = torch.from_numpy(img).to(device=device, dtype=dtype)
    pts = torch.from_numpy(pts).to(device)
    wts = torch.from_numpy(wts).to(device)
    if with_grad:
        return img, shapes, pts, wts, torch.from_numpy(og).to(device, dtype)
    return img, shapes, pts, wts


def _check(got, want, dtype, tol=None):
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape
    tol = TOL[dtype] if tol is None else tol
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= tol, f"max error {err} > {tol}"


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("cfg", CFGS)
def test_kernel_matches_plain(device, dtype, padding_mode, align_corners,
                              cfg):
    img, shapes, pts, wts = _inputs(device, dtype, **cfg)
    before = cuda_fwd.LAUNCHES
    got = cuda_fwd.msda_fwd(img, shapes, pts, wts, padding_mode,
                            align_corners)
    torch.cuda.synchronize()
    assert cuda_fwd.LAUNCHES == before + 1
    want = native_multiscale_deformable_attention(
        img, shapes, pts, wts, padding_mode, align_corners)
    _check(got, want, dtype)


def _fwd_inputs(device, dtype, shapes, N, C, P, B=2, H=3, seed=21):
    """Seeded inputs on ``shapes`` with out-of-bounds points."""
    rng = np.random.default_rng(seed)
    L, I = len(shapes), sum(h * w for h, w in shapes)  # noqa: E741
    img = torch.from_numpy(rng.standard_normal(
        (B, I, H, C), dtype=np.float32)).to(device, dtype)
    pts = torch.from_numpy(rng.random((B, N, H, L, P, 2), dtype=np.float32)
                           * 2.0 - 0.5).to(device)
    wts = torch.from_numpy(rng.random((B, N, H, L, P),
                                      dtype=np.float32)).to(device)
    return img, shapes, pts, wts


def _check_fwd(img, shapes, pts, wts, dtype, mode):
    before = cuda_fwd.LAUNCHES
    got = cuda_fwd.msda_fwd(img, shapes, pts, wts, *mode)
    torch.cuda.synchronize()
    assert cuda_fwd.LAUNCHES == before + 1
    _check(got, native_multiscale_deformable_attention(img, shapes, pts,
                                                        wts, *mode), dtype)


PYRAMID = [(16, 16), (8, 8), (4, 4), (2, 2)]
SIXTEEN_LEVELS = [(64 >> (lvl // 4), 48 >> (lvl // 4)) for lvl in range(16)]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("edge", ["T-1", "T", "T+1", "2T+1"])
def test_kernel_at_tile_edges(device, dtype, padding_mode, align_corners,
                              edge):
    """K1 gathers T consecutive (b, h, n) tasks a block: N of T - 1, T,
    T + 1 and 2T + 1 queries a head put tile ends inside a head, on its
    end and past it, and leave a ragged last tile."""
    img, shapes, pts, wts = _fwd_inputs(device, dtype, PYRAMID, 1, 32, 4)
    T = cuda_fwd.launch_plan(img, shapes, pts, wts)["tile"]
    N = {"T-1": T - 1, "T": T, "T+1": T + 1, "2T+1": 2 * T + 1}[edge]
    img, shapes, pts, wts = _fwd_inputs(device, dtype, PYRAMID, N, 32, 4)
    _check_fwd(img, shapes, pts, wts, dtype, (padding_mode, align_corners))


# rows of points that are not a multiple of 16 bytes, and more points a
# task than one chunk stages (msda_fwd_plan.cuh)
ROW_CASES = [
    dict(shapes=[(37, 53)], P=3, C=32),      # L*P = 3: 8- and 4-byte copies
    dict(shapes=SIXTEEN_LEVELS, P=1, C=32),  # 16 levels of one point
    dict(shapes=SIXTEEN_LEVELS, P=4, C=32),  # 64 points: two chunks
    dict(shapes=SIXTEEN_LEVELS, P=4, C=160),  # two chunks, two channel passes
    dict(shapes=[(37, 53)], P=33, C=30),     # chunks of 32 and 1; VEC = 1
]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("case", ROW_CASES,
                         ids=lambda c: f"L{len(c['shapes'])}P{c['P']}"
                                       f"C{c['C']}")
def test_kernel_with_odd_rows_and_point_chunks(device, dtype, padding_mode,
                                               align_corners, case):
    img, shapes, pts, wts = _fwd_inputs(device, dtype, case["shapes"], 45,
                                        case["C"], case["P"])
    plan = cuda_fwd.launch_plan(img, shapes, pts, wts)
    L, P = len(shapes), case["P"]
    assert plan["chunks"] == -(-L * P // plan["chunk"])
    if L * P % 2:
        assert plan["vw_pts"] == 2 and plan["vw_wts"] == 1
    _check_fwd(img, shapes, pts, wts, dtype, (padding_mode, align_corners))


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
def test_kernel_where_a_head_spans_many_tiles(device, dtype):
    """3,001 queries a head (about 94 tiles of 32), on a 64-base pyramid,
    so that a persistent block walks many tiles of one head."""
    shapes = [(64, 64), (32, 32), (16, 16), (8, 8)]
    img, shapes, pts, wts = _fwd_inputs(device, dtype, shapes, 3001, 32, 4,
                                        B=2, H=2)
    for mode in MODES:
        _check_fwd(img, shapes, pts, wts, dtype, mode)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
def test_kernel_takes_misaligned_points_and_weights(device, dtype):
    """Points and weights whose storage starts off an 8-byte boundary are
    copied 4 bytes at a time."""
    img, shapes, pts, wts = _fwd_inputs(device, dtype, PYRAMID, 77, 32, 4)
    pts, wts = _misaligned(pts), _misaligned(wts)
    plan = cuda_fwd.launch_plan(img, shapes, pts, wts)
    assert plan["vw_pts"] == plan["vw_wts"] == 1
    for mode in MODES:
        _check_fwd(img, shapes, pts, wts, dtype, mode)


def test_auto_routes_cuda_tensors_to_the_kernel(device):
    img, shapes, pts, wts = _inputs(device, torch.float32, N=50)
    before = cuda_fwd.LAUNCHES
    out = multiscale_deformable_attention(img, shapes, pts, wts)
    assert cuda_fwd.LAUNCHES == before + 1
    ref = multiscale_deformable_attention(img, shapes, pts, wts,
                                          impl="reference")
    assert cuda_fwd.LAUNCHES == before + 1
    _check(out, ref, torch.float32)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("cfg", CFGS)
def test_backward_kernel_matches_plain(device, dtype, padding_mode,
                                       align_corners, cfg):
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True, **cfg)
    before = cuda_bwd.LAUNCHES
    got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og, padding_mode,
                            align_corners)
    torch.cuda.synchronize()
    assert cuda_bwd.LAUNCHES == before + 1
    want = native_msda_backward(img, shapes, pts, wts, og, padding_mode,
                                align_corners)
    _check(got[0], want[0], dtype, IMG_GRAD_TOL[dtype])
    _check(got[1], want[1], torch.float32, POINT_GRAD_TOL)
    _check(got[2], want[2], torch.float32, POINT_GRAD_TOL)


def _misaligned(t):
    """A contiguous copy of ``t`` whose storage starts one element past an
    allocation: not 16-byte aligned (nor 8-byte in the half types)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 8 != 0
    return view


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_kernels_take_misaligned_tensors(device, dtype, padding_mode,
                                         align_corners):
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True, N=33)
    mode = (padding_mode, align_corners)
    want = native_multiscale_deformable_attention(img, shapes, pts, wts,
                                                  *mode)
    _check(cuda_fwd.msda_fwd(_misaligned(img), shapes, pts, wts, *mode),
           want, dtype)
    wants = native_msda_backward(img, shapes, pts, wts, og, *mode)
    for args in ((_misaligned(img), og), (img, _misaligned(og))):
        got = cuda_bwd.msda_bwd(args[0], shapes, pts, wts, args[1], *mode)
        _check(got[0], wants[0], dtype, IMG_GRAD_TOL[dtype])
        _check(got[1], wants[1], torch.float32, POINT_GRAD_TOL)
        _check(got[2], wants[2], torch.float32, POINT_GRAD_TOL)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_kernels_with_every_query_on_one_pixel(device, dtype, padding_mode,
                                               align_corners):
    """Every query of a head samples the same points, so the img_grad adds
    of a whole warp (and of every warp) fall on the same rows."""
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True,
                                        N=300, P=2)
    pts = pts[:, :1].expand_as(pts).contiguous()
    mode = (padding_mode, align_corners)
    _check(cuda_fwd.msda_fwd(img, shapes, pts, wts, *mode),
           native_multiscale_deformable_attention(img, shapes, pts, wts,
                                                  *mode), dtype)
    got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og, *mode)
    want = native_msda_backward(img, shapes, pts, wts, og, *mode)
    _check(got[0], want[0], dtype, IMG_GRAD_TOL[dtype])
    _check(got[1], want[1], torch.float32, POINT_GRAD_TOL)
    _check(got[2], want[2], torch.float32, POINT_GRAD_TOL)


def _merge_inputs(device, dtype, N=21847, C=32, P=3, seed=11):
    """Seeded inputs on a 64-base pyramid with out-of-bounds points."""
    img, shapes, pts, wts, og = get_functional_data(
        N=N, C=C, P=P, oob=True, seed=seed, base=64)
    to = lambda a, dt=torch.float32: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return (to(img, dtype), shapes, to(pts), to(wts), to(og, dtype))


def _check_bwd(got, want, dtype):
    _check(got[0], want[0], dtype, IMG_GRAD_TOL[dtype])
    _check(got[1], want[1], torch.float32, POINT_GRAD_TOL)
    _check(got[2], want[2], torch.float32, POINT_GRAD_TOL)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("C", [32, 30, 24, 160])
def test_backward_kernel_with_merged_adds(device, dtype, padding_mode,
                                         align_corners, C):
    """21,847 queries of 3 points on the 64-base pyramid, one launch.
    C = 32: groups of 8 lanes; C = 30: one channel a lane (groups of 32);
    C = 24: a partly idle group; C = 160: past G * VEC = 128 lanes'
    channels (the gather steps over C, one atomic a point)."""
    img, shapes, pts, wts, og = _merge_inputs(device, dtype, C=C)
    mode = (padding_mode, align_corners)
    before = cuda_bwd.LAUNCHES
    got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og, *mode)
    torch.cuda.synchronize()
    assert cuda_bwd.LAUNCHES == before + 1
    _check_bwd(got, native_msda_backward(img, shapes, pts, wts, og, *mode),
               dtype)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_backward_kernel_with_every_point_at_one_place(
        device, dtype, padding_mode, align_corners):
    """Every point of every (b, h) at one place on every level: 87,388
    points a level add into one set of four pixels (one f32 atomic a point
    drifted past the 1e-4 bar there; K2's exact adds hold it)."""
    img, shapes, pts, wts, og = _merge_inputs(device, dtype, P=4)
    pts = torch.tensor([0.43, 0.58], device=device).expand_as(pts)
    pts = pts.contiguous()
    mode = (padding_mode, align_corners)
    want = native_msda_backward(img, shapes, pts, wts, og, *mode)
    assert want[0].float().abs().max() > 10
    _check_bwd(cuda_bwd.msda_bwd(img, shapes, pts, wts, og, *mode), want,
               dtype)


def _bwd_inputs(device, dtype, shapes, N, C, P, B=2, H=3, seed=31):
    """Seeded inputs on ``shapes`` with out-of-bounds points and an
    out_grad."""
    img, shapes, pts, wts = _fwd_inputs(device, dtype, shapes, N, C, P, B=B,
                                        H=H, seed=seed)
    rng = np.random.default_rng(seed + 1)
    og = torch.from_numpy(rng.standard_normal(
        (B, N, H, C), dtype=np.float32)).to(device, dtype)
    return img, shapes, pts, wts, og


def _check_bwd_call(img, shapes, pts, wts, og, dtype, mode):
    before = cuda_bwd.LAUNCHES
    got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og, *mode)
    torch.cuda.synchronize()
    assert cuda_bwd.LAUNCHES == before + 1
    _check_bwd(got, native_msda_backward(img, shapes, pts, wts, og, *mode),
               dtype)


# the encoder's pyramid at 800x1333 (I = 22,223)
SLICE = [(100, 167), (50, 84), (25, 42), (13, 21)]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("edge", ["T-1", "T", "T+1", "2T+1"])
def test_backward_kernel_at_tile_edges(device, dtype, padding_mode,
                                       align_corners, edge):
    """K2 gathers T consecutive (b, n, h) tasks a block: T - 1, T, T + 1
    and 2T + 1 tasks put the launch's end inside a tile, on its end and
    past it, and leave a ragged last tile."""
    img, shapes, pts, wts, og = _bwd_inputs(device, dtype, PYRAMID, 1, 32,
                                            4, B=1, H=1)
    T = cuda_bwd.launch_plan(img, shapes, pts, wts, og)["tile"]
    n = {"T-1": T - 1, "T": T, "T+1": T + 1, "2T+1": 2 * T + 1}[edge]
    img, shapes, pts, wts, og = _bwd_inputs(device, dtype, PYRAMID, n, 32,
                                            4, B=1, H=1)
    assert cuda_bwd.launch_plan(img, shapes, pts, wts, og)["tiles"] == (
        -(-n // T))
    _check_bwd_call(img, shapes, pts, wts, og, dtype,
                    (padding_mode, align_corners))


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("case", ROW_CASES,
                         ids=lambda c: f"L{len(c['shapes'])}P{c['P']}"
                                       f"C{c['C']}")
def test_backward_kernel_with_odd_rows_and_point_chunks(
        device, dtype, padding_mode, align_corners, case):
    """Rows of points that are not a multiple of 16 bytes (8- and 4-byte
    copies), 16 levels of one point, two chunks of points, channel steps
    with chunks (C = 160: every point adds its own terms) and one channel a
    lane across chunks of 32 and 1."""
    img, shapes, pts, wts, og = _bwd_inputs(device, dtype, case["shapes"],
                                            45, case["C"], case["P"])
    plan = cuda_bwd.launch_plan(img, shapes, pts, wts, og)
    L, P = len(shapes), case["P"]
    assert plan["chunks"] == -(-L * P // plan["chunk"])
    assert plan["steps"] == -(-case["C"] // (plan["lanes"] * plan["vec"]))
    if L * P % 2:
        assert plan["vw_pts"] == 2 and plan["vw_wts"] == 1
    _check_bwd_call(img, shapes, pts, wts, og, dtype,
                    (padding_mode, align_corners))


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
def test_backward_kernel_where_a_head_spans_many_tiles(device, dtype):
    """3,001 queries of 2 heads (6,002 tasks a batch, about 375 tiles of
    16) on a 64-base pyramid, so that a persistent block walks many
    tiles."""
    shapes = [(64, 64), (32, 32), (16, 16), (8, 8)]
    img, shapes, pts, wts, og = _bwd_inputs(device, dtype, shapes, 3001, 32,
                                            4, B=2, H=2)
    for mode in MODES:
        _check_bwd_call(img, shapes, pts, wts, og, dtype, mode)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
def test_backward_kernel_takes_misaligned_points_and_weights(device, dtype):
    """Points and weights whose storage starts off an 8-byte boundary are
    copied 4 bytes at a time."""
    img, shapes, pts, wts, og = _bwd_inputs(device, dtype, PYRAMID, 77, 32,
                                            4)
    pts, wts = _misaligned(pts), _misaligned(wts)
    plan = cuda_bwd.launch_plan(img, shapes, pts, wts, og)
    assert plan["vw_pts"] == plan["vw_wts"] == 1
    for mode in MODES:
        _check_bwd_call(img, shapes, pts, wts, og, dtype, mode)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_backward_kernel_at_the_decoder_shape(device, dtype, padding_mode,
                                              align_corners):
    """The train step's decoder call: 300 queries against the encoder's
    22,223 pixels, 8 heads, 4,800 tasks: 300 tiles, fewer than the
    persistent grid holds."""
    img, shapes, pts, wts, og = _bwd_inputs(device, dtype, SLICE, 300, 32, 4,
                                            B=2, H=8)
    plan = cuda_bwd.launch_plan(img, shapes, pts, wts, og)
    assert plan["tiles"] * plan["tile"] == 2 * 300 * 8
    _check_bwd_call(img, shapes, pts, wts, og, dtype,
                    (padding_mode, align_corners))


def test_auto_backward_launches_the_backward_kernel_once(device):
    img, shapes, pts, wts, og = _inputs(device, torch.float32, with_grad=True,
                                        N=50)
    leaves = [t.clone().requires_grad_(True) for t in (img, pts, wts)]
    fwd, bwd = cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES
    out = multiscale_deformable_attention(leaves[0], shapes, *leaves[1:])
    out.backward(og)
    assert (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES) == (fwd + 1, bwd + 1)
    want = native_msda_backward(img, shapes, pts, wts, og)
    for leaf, w in zip(leaves, want):
        _check(leaf.grad, w, torch.float32, POINT_GRAD_TOL)


def test_double_backward_raises(device):
    img, shapes, pts, wts = _inputs(device, torch.float32, N=20)
    pts.requires_grad_(True)
    out = multiscale_deformable_attention(img, shapes, pts, wts, impl="cuda")
    (g,) = torch.autograd.grad(out.square().sum(), pts, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_operators_pass_opcheck_on_the_card(device, dtype, padding_mode):
    """The operators' CUDA implementations against their fake ones, their
    schema, autograd registration and AOT dispatch."""
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True, N=40)
    flat = library.flat_shapes(level_shapes(shapes))
    leaves = [t.clone().requires_grad_(True) for t in (img, pts, wts)]
    torch.library.opcheck(library.msda_fwd,
                          (*leaves, flat, padding_mode, False))
    torch.library.opcheck(library.msda_bwd,
                          (img, pts, wts, og, flat, padding_mode, False))


def test_operators_launch_the_kernels(device):
    """``torch.ops.msda_tpu_torch.msda_fwd`` / ``msda_bwd`` on CUDA
    tensors launch K1 / K2 once each, with the wrappers' results."""
    img, shapes, pts, wts, og = _inputs(device, torch.float32,
                                        with_grad=True, N=40)
    flat = library.flat_shapes(level_shapes(shapes))
    before = cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES
    out = library.msda_fwd(img, pts, wts, flat, "zeros", True)
    grads = library.msda_bwd(img, pts, wts, og, flat, "zeros", True)
    assert (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES) == (before[0] + 1,
                                                      before[1] + 1)
    assert torch.equal(out, cuda_fwd.msda_fwd(img, shapes, pts, wts,
                                              "zeros", True))
    want = native_msda_backward(img, shapes, pts, wts, og, "zeros", True)
    for g, w in zip(grads, want):
        _check(g, w, w.dtype, POINT_GRAD_TOL)


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(device):
    img, shapes, pts, wts, og = _inputs(device, torch.float32, with_grad=True,
                                        N=20)
    before = cuda_bwd.LAUNCHES
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        cuda_bwd.msda_bwd(img.double(), shapes, pts, wts, og.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts,
                          og.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_bwd.msda_bwd(img.cpu(), shapes, pts, wts, og)
    with pytest.raises(ValueError, match="dtype and device"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts, og.cpu())
    with pytest.raises(ValueError, match="dtype and device"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts, og.half())
    with pytest.raises(ValueError, match="out_grad must be"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts, og[:, :-1].contiguous())
    with pytest.raises(ValueError, match="shape mismatch"):
        cuda_bwd.msda_bwd(img, shapes, pts, wts[..., :1].contiguous(), og)
    assert cuda_bwd.LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    img, shapes, pts, wts = _inputs(device, torch.float32, N=20)
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        cuda_fwd.msda_fwd(img.double(), shapes, pts, wts)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fwd.msda_fwd(img.transpose(1, 2).contiguous().transpose(1, 2),
                          shapes, pts, wts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fwd.msda_fwd(img, shapes, pts.cpu(), wts)
    with pytest.raises(ValueError, match="pixels"):
        cuda_fwd.msda_fwd(img[:, 1:].contiguous(), shapes, pts, wts)


LEVELS = [(16, 16), (8, 8), (4, 4), (2, 2)]


def _small_model(device, impl):
    model = DeformableDetr(num_classes=8, in_channels=[32] * 4, emb_dim=64,
                           num_heads=4, num_points=2, num_queries=16,
                           ffn_dim=128, with_box_refinement=True, impl=impl,
                           device=device)
    return init_parameters(model, torch.Generator().manual_seed(0))


def _small_pyramid(device):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(
        rng.standard_normal((2, h, w, 32)).astype(np.float32)).to(device)
        for h, w in LEVELS]


def test_small_model_cuda_matches_reference(device):
    pyramid = _small_pyramid(device)
    outs = {}
    for impl in ("cuda", "reference"):
        with torch.inference_mode():
            outs[impl] = _small_model(device, impl)(pyramid, LEVELS)
    for k in ("logits", "boxes"):
        np.testing.assert_allclose(outs["cuda"][k].cpu().numpy(),
                                   outs["reference"][k].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_small_model_gradients_cuda_match_reference(device):
    """Every parameter's gradient through the detection loss, within 1e-4
    of the tensor's largest gradient, that scale being at least 1e-3 of the
    model's largest gradient (the self-attention key bias has a gradient
    that is zero in exact arithmetic, so it holds rounding noise only)."""
    pyramid = _small_pyramid(device)
    rng = np.random.default_rng(1)
    targets = {
        "labels": torch.from_numpy(rng.integers(0, 8, (2, 5))).to(device),
        "boxes": torch.from_numpy(
            rng.uniform(0.2, 0.6, (2, 5, 4)).astype(np.float32)).to(device),
        "mask": torch.ones(2, 5, device=device),
    }
    grads, losses = {}, {}
    for impl in ("cuda", "reference"):
        model = _small_model(device, impl)
        before = cuda_bwd.LAUNCHES
        loss = detection_loss(model(pyramid, LEVELS), targets,
                              class_loss="focal")
        loss.backward()
        assert cuda_bwd.LAUNCHES - before == (4 if impl == "cuda" else 0)
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
    assert losses["cuda"] == pytest.approx(losses["reference"], rel=1e-5)
    floor = 1e-3 * max(w.abs().max().item()
                       for w in grads["reference"].values())
    for name, want in grads["reference"].items():
        got = grads["cuda"][name]
        scale = max(want.abs().max().item(), floor)
        err = (got - want).abs().max().item() / scale
        assert err <= 1e-4, f"{name}: {err}"


# base 12: levels 12x12, 6x6, 3x3, 1x1 (no width a multiple of 8); the plans
# cut them into several bands and column tiles
STREAM_CFGS = [
    dict(N=130, P=3, base=12, plan=((3, 5), (2, 100), (1, 1), (1, 1))),
    dict(N=37, C=48, P=9, base=12, plan=((4, 4), (2, 3), (100, 100),
                                         (1, 1))),
    dict(N=50, C=6, P=2, base=12, plan=None),  # one channel per lane
]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
@pytest.mark.parametrize("cfg", range(len(STREAM_CFGS)))
def test_stream_kernels_match_plain(device, dtype, padding_mode,
                                    align_corners, cfg):
    cfg = dict(STREAM_CFGS[cfg])
    plan = cfg.pop("plan")
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True, **cfg)
    mode = (padding_mode, align_corners)
    before = dict(cuda_stream.LAUNCHES)
    got = cuda_stream.msda_stream_fwd(img, shapes, pts, wts, *mode,
                                      plan=plan)
    grads = cuda_stream.msda_stream_bwd(img, shapes, pts, wts, og, *mode,
                                        plan=plan)
    torch.cuda.synchronize()
    assert cuda_stream.LAUNCHES == {
        "msda_stream_bin": before["msda_stream_bin"] + 2,
        "msda_stream_fwd": before["msda_stream_fwd"] + 1,
        "msda_stream_bwd": before["msda_stream_bwd"] + 1}
    _check(got, stream.plain_stream_fwd(img, shapes, pts, wts, *mode,
                                        plan=plan), dtype)
    want = stream.plain_stream_bwd(img, shapes, pts, wts, og, *mode,
                                   plan=plan)
    _check(grads[0], want[0], dtype, IMG_GRAD_TOL[dtype])
    _check(grads[1], want[1], torch.float32, POINT_GRAD_TOL)
    _check(grads[2], want[2], torch.float32, POINT_GRAD_TOL)


def _tile_pixels(shapes, plan, bh):
    """Staged pixels of every bin's tile, for ``bh`` (b, h) pairs."""
    px = [min(yb + 1, h - y0) * min(xb + 1, w - x0)
          for (h, w), (yb, xb) in zip(shapes, plan)
          for y0 in range(0, h, yb) for x0 in range(0, w, xb)]
    return torch.tensor(px * bh, dtype=torch.int64)


def _check_bins(device, pts, wts, shapes, plan):
    records, starts, counts, staged = cuda_stream.bin_samples(
        pts, wts, shapes, plan)
    order = records.view(torch.int32)[:, 3]
    # each record: the sample's point and weight, and its index
    assert torch.equal(records[:, :2], pts.reshape(-1, 2)[order.long()])
    assert torch.equal(records[:, 2], wts.flatten()[order.long()])
    bins = stream.sample_bins(pts, shapes, plan).flatten()
    want = torch.bincount(bins, minlength=counts.numel())
    assert torch.equal(counts.long(), want)
    assert torch.equal(starts.long(), torch.cumsum(want, 0) - want)
    assert torch.equal(torch.sort(order.long()).values,
                       torch.arange(order.numel(), device=device))
    assert torch.equal(bins[order.long()], torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), want))
    # the cost line: the staged pixels of the non-empty tiles before a bin
    px = _tile_pixels(shapes, plan, pts.shape[0] * pts.shape[2]).to(device)
    px = torch.where(want > 0, px, 0)
    assert torch.equal(staged.cpu(), torch.cat(
        [torch.zeros(1, dtype=torch.int64), torch.cumsum(px, 0).cpu(),
         torch.zeros(1, dtype=torch.int64)]))


def test_stream_binning_matches_sample_bins(device):
    _, shapes, pts, wts = _inputs(device, torch.float32, N=300, P=4, base=12)
    _check_bins(device, pts, wts, shapes, ((2, 5), (1, 2), (1, 1), (1, 1)))


def test_stream_kernels_past_the_shared_histogram(device):
    """16,384 bins per (b, h), more than a binning block counts in shared
    memory (12,288): the binning adds to the global counts directly."""
    img, shapes, pts, wts, og = _inputs(device, torch.float32,
                                        with_grad=True, N=60, P=2, L=1,
                                        base=128)
    plan = ((1, 1),)
    assert stream.num_bins(shapes, plan) == 128 * 128
    _check_bins(device, pts, wts, shapes, plan)
    _check(cuda_stream.msda_stream_fwd(img, shapes, pts, wts, plan=plan),
           stream.plain_stream_fwd(img, shapes, pts, wts, plan=plan),
           torch.float32)
    grads = cuda_stream.msda_stream_bwd(img, shapes, pts, wts, og, plan=plan)
    want = stream.plain_stream_bwd(img, shapes, pts, wts, og, plan=plan)
    for g, w, tol in zip(grads, want, (IMG_GRAD_TOL[torch.float32],
                                       POINT_GRAD_TOL, POINT_GRAD_TOL)):
        _check(g, w, torch.float32, tol)


def _check_stream(img, shapes, pts, wts, og, mode, plan, dtype,
                  og_kernel=None):
    """Both streamed kernels against their plain versions (``og_kernel``:
    the out_grad the backward kernel gets, same values as ``og``)."""
    _check(cuda_stream.msda_stream_fwd(img, shapes, pts, wts, *mode,
                                       plan=plan),
           stream.plain_stream_fwd(img, shapes, pts, wts, *mode, plan=plan),
           dtype)
    grads = cuda_stream.msda_stream_bwd(
        img, shapes, pts, wts, og if og_kernel is None else og_kernel,
        *mode, plan=plan)
    want = stream.plain_stream_bwd(img, shapes, pts, wts, og, *mode,
                                   plan=plan)
    _check(grads[0], want[0], dtype, IMG_GRAD_TOL[dtype])
    _check(grads[1], want[1], torch.float32, POINT_GRAD_TOL)
    _check(grads[2], want[2], torch.float32, POINT_GRAD_TOL)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_stream_kernels_with_every_point_of_a_head_on_one_pixel(
        device, dtype, padding_mode, align_corners):
    """Every point of a (b, h) at one place: each level's samples of a
    (b, h) fall on one pixel, so the backward sorts runs of one pixel and
    merges their img_grad adds.  A bin holds 18,000 samples and a block's
    share of the 576,000 about 2,200, so blocks serve a bin in several
    slices (of 1,024) and several blocks share one bin."""
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True,
                                        N=4500, P=4, base=32)
    pts = pts[:, :1, :, :1, :1].expand_as(pts).contiguous()
    _check_stream(img, shapes, pts, wts, og, (padding_mode, align_corners),
                  None, dtype)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
def test_stream_kernels_with_empty_bins_and_unequal_tiles(device, dtype):
    """Every point in one band of each level (most bins empty), over tiles
    of unequal size in one launch: column tiles with a narrow last one, a
    whole level, and full-width bands."""
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True,
                                        N=500, P=4, base=24)
    pts[..., 1] = 0.40 + 0.01 * pts[..., 1]
    plan = ((5, 7), (2, 100), (100, 100), (1, 3))
    for mode in MODES:
        _check_stream(img, shapes, pts, wts, og, mode, plan, dtype)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("C", [6, 30, 34, 48])
def test_stream_kernels_one_channel_a_lane(device, dtype, C):
    """VEC = 1: C = 6, 30 and 34 (not multiples of 4; 34 takes two steps
    of 32 lanes, so the sums are added per sample, not merged), and C = 48
    with an out_grad view that is not 16-byte aligned (the backward's
    VEC = 1 at two steps).  C = 6 and the half types' C = 30 and 34 stage
    element by element."""
    img, shapes, pts, wts, og = _inputs(device, dtype, with_grad=True,
                                        N=77, P=3, C=C, base=20)
    plan = ((4, 6), (3, 100), (100, 100), (1, 1))
    for mode in MODES:
        _check_stream(img, shapes, pts, wts, og, mode, plan, dtype,
                      og_kernel=_misaligned(og) if C == 48 else None)


def test_forced_auto_launches_only_the_streamed_kernels(device):
    img, shapes, pts, wts, og = _inputs(device, torch.float32,
                                        with_grad=True, N=50)
    leaves = [t.clone().requires_grad_(True) for t in (img, pts, wts)]
    before = (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES,
              dict(cuda_stream.LAUNCHES))
    with stream.forced():
        out = multiscale_deformable_attention(leaves[0], shapes, *leaves[1:])
        out.backward(og)
    assert (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES) == before[:2]
    assert cuda_stream.LAUNCHES["msda_stream_fwd"] == (
        before[2]["msda_stream_fwd"] + 1)
    assert cuda_stream.LAUNCHES["msda_stream_bwd"] == (
        before[2]["msda_stream_bwd"] + 1)
    _check(out.detach(), native_multiscale_deformable_attention(
        img, shapes, pts, wts), torch.float32)
    want = native_msda_backward(img, shapes, pts, wts, og)
    for leaf, w in zip(leaves, want):
        _check(leaf.grad, w, torch.float32, POINT_GRAD_TOL)


def test_stream_wrappers_reject_what_the_kernels_do_not_take(device):
    img, shapes, pts, wts, og = _inputs(device, torch.float32,
                                        with_grad=True, N=20)
    before = dict(cuda_stream.LAUNCHES)
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        cuda_stream.msda_stream_fwd(img.double(), shapes, pts, wts)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_stream.msda_stream_fwd(
            img.transpose(1, 2).contiguous().transpose(1, 2), shapes, pts,
            wts)
    with pytest.raises(ValueError, match="dtype and device"):
        cuda_stream.msda_stream_bwd(img, shapes, pts, wts, og.half())
    # a whole 128x128 level of 32 f32 channels is 2 MB of shared memory
    big = torch.zeros((1, 128 * 128, 1, 32), device=device)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_stream.msda_stream_fwd(
            big, ((128, 128),), pts[:1, :, :1, :1].contiguous(),
            wts[:1, :, :1, :1].contiguous(), plan=[(128, 128)])
    assert cuda_stream.LAUNCHES == before


# the auction kernel: (B, N, M, kind, max_rounds); (2, 900, 300) keeps its
# costs in global memory (past shared memory), the rest in shared memory
AUCTION_CASES = [
    (2, 300, 50, "uniform", 2000),
    (3, 40, 12, "ties", 2000),
    (2, 16, 16, "constant", 2000),
    (4, 300, 50, "masked", 2000),
    (2, 48, 48, "uniform", 17),
    (2, 900, 300, "ties", 2000),
]


@pytest.mark.parametrize("B,N,M,kind,max_rounds", AUCTION_CASES)
def test_auction_kernel_matches_plain(device, B, N, M, kind, max_rounds):
    """``query_idx`` and ``converged`` equal to the plain loop's, exactly
    (the kernel does the plain version's f32 arithmetic in its order)."""
    rng = np.random.default_rng(B * N + M)
    cost = rng.random((B, N, M), dtype=np.float32)
    active = None
    if kind == "ties":
        cost = np.floor(cost * 4)
    elif kind == "constant":
        cost = np.full_like(cost, 0.5)
    elif kind == "masked":
        active = np.zeros((B, M), bool)
        active[:, :7] = True
        cost = np.where(active[:, None, :], cost, 0)
        active = torch.from_numpy(active).to(device)
    cost = torch.from_numpy(np.ascontiguousarray(cost, np.float32)).to(device)
    before = cuda_matcher.LAUNCHES
    q, conv, rounds = cuda_matcher.auction(cost, active, 1e-3, max_rounds)
    assert cuda_matcher.LAUNCHES == before + 1
    want_q, want_conv = plain_auction(cost, active, 1e-3, max_rounds)
    assert torch.equal(q, want_q) and torch.equal(conv, want_conv)
    assert (rounds <= max_rounds).all() and (rounds >= 1).all()
    # through the public entry point: one launch a call, also unbatched
    got = auction_assignment(cost[0], None if active is None else active[0],
                             max_rounds=max_rounds)
    assert torch.equal(got, want_q[0])
    assert cuda_matcher.LAUNCHES == before + 2


def test_auction_wrapper_rejects_what_the_kernel_does_not_take(device):
    cost = torch.rand(2, 10, 4, device=device)
    before = cuda_matcher.LAUNCHES
    with pytest.raises(ValueError, match="f32"):
        cuda_matcher.auction(cost.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_matcher.auction(cost.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="more targets"):
        cuda_matcher.auction(torch.rand(1, 3, 4, device=device))
    with pytest.raises(ValueError, match="active"):
        cuda_matcher.auction(cost, torch.ones(2, 5, dtype=torch.bool,
                                              device=device))
    assert cuda_matcher.LAUNCHES == before


def _small_targets(device, seed):
    rng = np.random.default_rng(seed)
    return {
        "labels": torch.from_numpy(rng.integers(0, 8, (2, 5))).to(device),
        "boxes": torch.from_numpy(
            rng.uniform(0.2, 0.6, (2, 5, 4)).astype(np.float32)).to(device),
        "mask": torch.ones(2, 5, device=device),
    }


def _assert_same_step(graphed, eager, loss, want):
    """The graphed step's loss within 1e-5 of the eager step's, and the
    parameters after it within 1e-6 of the floored scale (K2's atomics)."""
    assert loss.item() == pytest.approx(want.item(), rel=1e-5)
    floor = 1e-3 * max(q.abs().max().item() for q in eager.parameters())
    for (name, p), q in zip(graphed.named_parameters(), eager.parameters()):
        scale = max(q.abs().max().item(), floor)
        assert (p - q).abs().max().item() <= 1e-6 * scale, name


def test_graphed_step_matches_the_eager_step(device):
    """The small model's step captured as a CUDA graph (SGD; the warm-up at
    lr 0 leaves the parameters as they are): the captured step's loss equal
    to the eager step's, the parameters after it within 1e-6 of the floored
    scale (K2's atomics), and each replay counted as K1, K2 and the auction
    kernel's launches.  A third call, on a second batch of the same shapes,
    replays on the inputs copied in: held to the eager step on that batch
    from the same parameters, at the same bars."""
    pyramid, targets = _small_pyramid(device), _small_targets(device, 2)
    rng = np.random.default_rng(1)
    batch_b = ([torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)).to(device) for t in pyramid], _small_targets(device, 3))
    kw = dict(matcher="auction", class_loss="focal")
    graphed, eager = (_small_model(device, "cuda").train() for _ in range(2))
    sgd = torch.optim.SGD(graphed.parameters(), lr=0.0)
    step = make_train_step(graphed, sgd, LEVELS, **kw)
    step(pyramid, targets)  # the warm-up
    sgd.param_groups[0]["lr"] = 1e-3
    before = (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES, cuda_matcher.LAUNCHES)
    loss = step(pyramid, targets)  # the capture and its replay
    step_eager = make_train_step(eager, torch.optim.SGD(
        eager.parameters(), lr=1e-3), LEVELS, **kw).__wrapped__
    want = step_eager(pyramid, targets)
    # 2 + 2 layers, 2 heads with box refinement (an auction each), in the
    # replay and in the eager step
    assert (cuda_fwd.LAUNCHES - before[0], cuda_bwd.LAUNCHES - before[1],
            cuda_matcher.LAUNCHES - before[2]) == (4 + 4, 4 + 4, 2 + 2)
    _assert_same_step(graphed, eager, loss, want)
    # the replay on batch b, against the eager step on it from the graphed
    # model's parameters (a replay on batch a's inputs would update them
    # otherwise)
    eager.load_state_dict(graphed.state_dict())
    loss = step(*batch_b)
    want = step_eager(*batch_b)
    _assert_same_step(graphed, eager, loss, want)
    with pytest.raises(ValueError, match="capturable"):
        make_train_step(eager, torch.optim.AdamW(eager.parameters()),
                        LEVELS, **kw)


def test_graphed_step_takes_an_lr_change(device):
    """A scheduler's change of a float lr after the capture takes effect:
    the next call captures the step again, and its update is the eager
    step's at the new lr from the same parameters."""
    pyramid, targets = _small_pyramid(device), _small_targets(device, 2)
    kw = dict(matcher="auction", class_loss="focal")
    graphed, eager = (_small_model(device, "cuda").train() for _ in range(2))
    sgd = torch.optim.SGD(graphed.parameters(), lr=1e-3)
    step = make_train_step(graphed, sgd, LEVELS, **kw)
    for _ in range(3):  # the warm-up, the capture and its replay, a replay
        step(pyramid, targets)
    schedule = torch.optim.lr_scheduler.StepLR(sgd, step_size=1, gamma=5.0)
    schedule.step()
    assert sgd.param_groups[0]["lr"] == pytest.approx(5e-3)
    eager.load_state_dict(graphed.state_dict())
    loss = step(pyramid, targets)
    want = make_train_step(eager, torch.optim.SGD(
        eager.parameters(), lr=5e-3), LEVELS, **kw).__wrapped__(
        pyramid, targets)
    _assert_same_step(graphed, eager, loss, want)


def _serving(device):
    """The small two-stage detector's graphed request (forward +
    ``postprocess``) and the device ``image_sizes`` of a batch of 2."""
    model = DeformableDetr(num_classes=8, in_channels=[32] * 4, emb_dim=64,
                           num_heads=4, num_points=2, num_queries=16,
                           ffn_dim=128, with_box_refinement=True,
                           two_stage=True, impl="cuda", device=device)
    model = init_parameters(model, torch.Generator().manual_seed(0)).eval()
    serve = graphed(lambda pyr, sizes: postprocess(
        model(pyr, LEVELS), top_k=10, scoring="sigmoid", image_sizes=sizes))
    sizes = torch.tensor([[128, 120], [96, 128]], device=device)
    return serve, sizes


def _pyramid(device, batch, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        rng.standard_normal((batch, h, w, 32)).astype(np.float32)).to(device)
        for h, w in LEVELS]


def _assert_same_detections(got, want):
    """Labels equal; scores and boxes within 1e-5 of max(1, |eager|)."""
    assert torch.equal(got["labels"], want["labels"])
    for k in ("scores", "boxes"):
        _check(got[k], want[k], torch.float32)


def test_graphed_request_matches_the_eager_request(device):
    """The small two-stage detector served through ``graphed`` under
    ``inference_mode``: the capture's replay equal to the eager request
    (``__wrapped__``), 4 K1 launches a request, replays included; a replay
    on a second pyramid equal to the eager request on it, and not to the
    first request's detections."""
    serve, sizes = _serving(device)
    a, b = _pyramid(device, 2, 1), _pyramid(device, 2, 2)
    with torch.inference_mode():
        serve(a, sizes)  # the warm-up
        before = cuda_fwd.LAUNCHES
        got_a = serve(a, sizes)  # the capture and its replay
        got_b = serve(b, sizes)
        assert cuda_fwd.LAUNCHES - before == 2 * 4
        _assert_same_detections(got_a, serve.__wrapped__(a, sizes))
        _assert_same_detections(got_b, serve.__wrapped__(b, sizes))
    assert not torch.equal(got_a["scores"], got_b["scores"])


def test_graphed_request_takes_a_second_signature(device):
    """Batch 1 after batch 2: a warm-up and a capture of its own, equal to
    its eager request; batch 2 still replays its own graph."""
    serve, sizes = _serving(device)
    two, one = _pyramid(device, 2, 1), _pyramid(device, 1, 3)
    with torch.inference_mode():
        for _ in range(3):
            serve(two, sizes)
        for _ in range(2):
            got = serve(one, sizes[:1])
        _assert_same_detections(got, serve.__wrapped__(one, sizes[:1]))
        _assert_same_detections(serve(two, sizes),
                                serve.__wrapped__(two, sizes))
