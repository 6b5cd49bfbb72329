"""The port's large-pyramid path (``msda_tpu_torch.ops.stream``) on the CPU.

The plain streamed versions, which the card holds the streamed CUDA kernels
against, are held here against the JAX streamed kernels K3-K5
(``pallas_stream.stream_fwd`` / ``stream_bwd``) run by the Pallas
interpreter in exact f32 (``scheme="highest"``), across several bands per
level, and against the port's gather versions for band heights of 1, 2 and
the whole level, and for column tiles.  Also: the band plan, the binning's
invariant, the operators' CUDA implementations with the kernels' wrappers
replaced by recorders (K1 and K2 unless ``stream.FORCE``), the op's CPU
dispatch, ``utils.bench`` and ``python -m msda_tpu_torch.benchmark`` on the
CPU.

Tolerances, as ``tests/test_stream.py``: 1e-5 on the output, the image and
the weight gradients, 1e-4 on the point gradients (sums of terms as large as
the level's width); f64 1e-8.
"""

import csv
import subprocess
import sys
from itertools import product
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from msda_tpu.ops import pallas_stream as ps  # noqa: E402
from msda_tpu_torch import benchmark  # noqa: E402
from msda_tpu_torch.ops import (  # noqa: E402
    cuda_bwd,
    cuda_fwd,
    cuda_stream,
    library,
    multiscale_deformable_attention,
    native_msda_backward,
    native_multiscale_deformable_attention,
    stream,
)
from msda_tpu_torch.utils import (  # noqa: E402
    device_memory_stats,
    reference_workload,
    timeit_op,
)
from utils import get_functional_data  # noqa: E402

MODES = list(product(["border", "zeros"], [False, True]))
REF = ((64, 64), (32, 32), (16, 16), (8, 8))
BIG = ((256, 256), (128, 128), (64, 64), (32, 32))
DETR = ((100, 167), (50, 84), (25, 42), (13, 21))  # 800x1333, strides 8-64


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _f32(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


# base 20: levels 20x20, 10x10, 5x5, 2x2, no width a multiple of 8
def _jax_data():
    return get_functional_data(B=1, H=2, N=67, P=3, oob=True, base=20,
                               seed=7)


@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_plain_stream_matches_jax_stream(monkeypatch, padding_mode,
                                         align_corners):
    """Both sides banded: JAX with 8-row bands (levels 0 and 1 in 3 and 2
    bands), the port with the same bands, with 3x4 column tiles, and with
    its default plan (44 KiB tiles: level 0 in bands of 16 rows)."""
    monkeypatch.setattr(ps, "BAND_ROWS_STREAM_SMALL", 8)
    img, shapes, pts, wts, og = _jax_data()
    shapes_tuple = tuple((int(h), int(w)) for h, w in shapes)
    kw = dict(shapes_tuple=shapes_tuple, padding_mode=padding_mode,
              align_corners=align_corners, scheme="highest", interpret=True)
    want_out = np.asarray(ps.stream_fwd(*_f32(img, pts, wts), **kw))
    want = [np.asarray(g) for g in ps.stream_bwd(*_f32(img, pts, wts, og),
                                                 **kw)]
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    assert stream.pyramid_plan(shapes_tuple, 32, torch.float32)[0] == (
        16, 20)
    for plan in ([(8, w) for _, w in shapes_tuple], [(3, 4)] * 4, None):
        out = stream.plain_stream_fwd(ti, shapes_tuple, tp, tw, padding_mode,
                                      align_corners, plan=plan)
        np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5,
                                   rtol=1e-5, err_msg=f"out, plan {plan}")
        got = stream.plain_stream_bwd(ti, shapes_tuple, tp, tw, tog,
                                      padding_mode, align_corners, plan=plan)
        for name, g, w, tol in zip(("img", "points", "weights"), got, want,
                                   (1e-5, 1e-4, 1e-5)):
            np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=tol,
                                       err_msg=f"{name} gradient, {plan}")


PLANS = {
    "band_rows_1": (1, 1000),
    "band_rows_2": (2, 1000),
    "whole_levels": (1000, 1000),
    "column_tiles": (3, 2),
}
TOLS = {np.float32: (1e-5, 1e-4), np.float64: (1e-8, 1e-8)}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("padding_mode,align_corners", MODES)
def test_plain_stream_matches_gather_version(plan, dtype, padding_mode,
                                             align_corners):
    img, shapes, pts, wts, og = get_functional_data(
        N=61, P=3, oob=True, base=12, dtype=dtype, seed=8)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    mode = (padding_mode, align_corners)
    tol, point_tol = TOLS[dtype]
    plan = [PLANS[plan]] * len(shapes)
    out = stream.plain_stream_fwd(ti, shapes, tp, tw, *mode, plan=plan)
    want = native_multiscale_deformable_attention(ti, shapes, tp, tw, *mode)
    assert out.dtype == want.dtype
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=tol,
                               rtol=tol)
    got = stream.plain_stream_bwd(ti, shapes, tp, tw, tog, *mode, plan=plan)
    wants = native_msda_backward(ti, shapes, tp, tw, tog, *mode)
    for name, g, w, t in zip(("img", "points", "weights"), got, wants,
                             (tol, point_tol, tol)):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=t, rtol=t,
                                   err_msg=f"{name} gradient")


def test_plain_stream_rounds_half_types_once():
    img, shapes, pts, wts, og = get_functional_data(N=40, P=3, oob=True,
                                                    base=12, seed=9)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    half = ti.to(torch.bfloat16)
    out = stream.plain_stream_fwd(half, shapes, tp, tw)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, stream.plain_stream_fwd(
        half.float(), shapes, tp, tw).to(torch.bfloat16))
    grads = stream.plain_stream_bwd(half, shapes, tp, tw,
                                    tog.to(torch.bfloat16))
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.float32,
                                        torch.float32]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_sample_bins_put_every_corner_in_its_tile(plan):
    """The binning's invariant: a sample's four corners lie in the tile of
    its bin, halo row and column included."""
    _, shapes, pts, _, _ = get_functional_data(B=2, H=3, N=50, P=3,
                                               oob=True, base=12, seed=10)
    (tp,) = _torch(pts)
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    plan = [PLANS[plan]] * len(shapes)
    bins = stream.sample_bins(tp, shapes, plan)
    per_bh = stream.num_bins(shapes, plan)
    B, N, H, L, P, _ = tp.shape
    assert bins.shape == (B, N, H, L, P)
    bh = torch.arange(B)[:, None] * H + torch.arange(H)[None, :]
    local = bins - (bh * per_bh)[:, None, :, None, None]
    first = 0
    for l, ((h, w), (yb, xb)) in enumerate(zip(shapes, plan)):
        ncb, nrb = -(-w // xb), -(-h // yb)
        key = local[:, :, :, l] - first
        assert key.min() >= 0 and key.max() < nrb * ncb
        y0, x0 = (key // ncb) * yb, (key % ncb) * xb
        x = tp[:, :, :, l, :, 0] * w - 0.5
        y = tp[:, :, :, l, :, 1] * h - 0.5
        for corner, lo, extent, size in (
                (torch.floor(x), x0, w, xb), (torch.floor(y), y0, h, yb)):
            for c in (corner, corner + 1):
                c = c.clamp(0, extent - 1).long()
                assert ((c >= lo) & (c <= lo + size)).all()
        first += nrb * ncb


def test_band_plan_of_the_256_base_pyramid():
    """Tiles of 44 KiB (a ring of two a block, two blocks an SM): 9 x 39
    pixels of 32 f32 channels, 9 x 78 in bf16; the 32x32 level in bands of
    10 (f32) and 21 (bf16) rows."""
    assert stream.TILE_BYTES == 45_056
    assert stream.pyramid_plan(BIG, 32, torch.float32) == (
        (8, 38), (8, 38), (8, 38), (10, 32))
    assert stream.pyramid_plan(BIG, 32, torch.bfloat16) == (
        (8, 77), (8, 77), (10, 64), (21, 32))
    assert stream.num_bins(BIG, stream.pyramid_plan(
        BIG, 32, torch.float32)) == 224 + 64 + 16 + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("base", [64, 128, 256, 512])
def test_band_plan_covers_the_sweep(dtype, base):
    shapes = tuple((base >> i, base >> i) for i in range(4))
    plan = stream.pyramid_plan(shapes, 32, dtype)
    assert stream.check_plan(shapes, plan, 32, dtype) == plan
    assert stream.check_plan(shapes, None, 32, dtype) == plan
    for (h, w), (yb, xb) in zip(shapes, plan):
        assert stream.tile_bytes(h, w, yb, xb, 32, dtype) <= stream.TILE_BYTES
        # a level that fits stays whole; bands are never thinner than the
        # plan's minimum unless the level is
        if h * w * 32 * torch.empty((), dtype=dtype).element_size() <= (
                stream.TILE_BYTES):
            assert (yb, xb) == (h, w)
        else:
            assert yb >= min(h, stream.MIN_BAND_ROWS)


def test_band_plan_raises_for_a_level_it_cannot_take():
    with pytest.raises(ValueError, match="shared memory"):
        stream.band_plan(64, 64, 8192, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        stream.check_plan(BIG, [(255, 255)] * 4, 32, torch.float32)
    with pytest.raises(ValueError, match="one \\(yb, xb\\)"):
        stream.check_plan(BIG, [(8, 8)] * 3, 32, torch.float32)


@pytest.fixture
def recorded(monkeypatch):
    """The four kernel wrappers replaced by recorders: each call appends
    ``(wrapper, args)`` and returns the wrapper's name."""
    calls = []
    for module, name in ((cuda_fwd, "msda_fwd"), (cuda_bwd, "msda_bwd"),
                         (cuda_stream, "msda_stream_fwd"),
                         (cuda_stream, "msda_stream_bwd")):
        def record(*args, name=name):
            calls.append((name, args))
            return name
        monkeypatch.setattr(module, name, record)
    return calls


def _op_calls(shapes, dtype, B, N, mode=("border", False)):
    """``library._fwd_cuda`` and ``_bwd_cuda`` once each on ``meta``
    tensors of the op's shapes (H=8, C=32, P=4): nothing is allocated.
    Returns the inputs and both results."""
    I = sum(h * w for h, w in shapes)  # noqa: E741
    img = torch.empty((B, I, 8, 32), dtype=dtype, device="meta")
    pts = torch.empty((B, N, 8, len(shapes), 4, 2), device="meta")
    wts = torch.empty((B, N, 8, len(shapes), 4), device="meta")
    og = torch.empty((B, N, 8, 32), dtype=dtype, device="meta")
    flat = library.flat_shapes(shapes)
    out = library._fwd_cuda(img, pts, wts, flat, *mode)
    grads = library._bwd_cuda(img, pts, wts, og, flat, *mode)
    return (img, pts, wts, og), out, grads


def _assert_reached(calls, fwd, bwd, shapes, inputs, mode=("border", False)):
    """``calls`` are ``fwd`` then ``bwd``, each with the op's own tensors,
    the level shapes as pairs and ``mode``."""
    img, pts, wts, og = inputs
    assert [name for name, _ in calls] == [fwd, bwd]
    for (_, args), tensors in zip(calls, ((img, pts, wts),
                                          (img, pts, wts, og))):
        assert args[1] == tuple(shapes)
        assert all(a is t for a, t in zip(args[:1] + args[2:], tensors))
        assert args[len(tensors) + 1:] == mode


def _square(base):
    return tuple((base >> i, base >> i) for i in range(4))


def _model(h, w):
    return tuple((-(-h // s), -(-w // s)) for s in (8, 16, 32, 64))


# The sweep that settled the dispatch (chip_smoke.py's phase 7d up to
# commit 045b20d; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): whole calls
# in ms, H=8, C=32, P=4; uniform points at B=4, N=10,000, and encoder
# layer 0's call of the full-width model at batch 2 (batch 1 at 2560x4266
# and 3200x5332).  Per point and dtype: K1, the streamed forward, K2, the
# streamed backward.
SWEEP = {
    ("base 64", torch.float32): (0.2575, 0.4172, 1.0963, 1.2384),
    ("base 64", torch.bfloat16): (0.2549, 0.4593, 1.1265, 1.3473),
    ("base 128", torch.float32): (0.2934, 0.4679, 1.2602, 1.3489),
    ("base 128", torch.bfloat16): (0.2547, 0.4636, 1.2086, 1.4168),
    ("base 256", torch.float32): (0.3475, 0.5629, 1.9862, 1.5887),
    ("base 256", torch.bfloat16): (0.2715, 0.5447, 2.1133, 1.7507),
    ("base 512", torch.float32): (0.5232, 1.0899, 3.0910, 2.7393),
    ("base 512", torch.bfloat16): (0.3811, 0.8517, 3.6535, 3.2915),
    ("800x1333", torch.float32): (0.2752, 0.4464, 1.3107, 1.3422),
    ("800x1333", torch.bfloat16): (0.2746, 0.4945, 1.3511, 1.4713),
    ("1200x2000", torch.float32): (0.5967, 0.8995, 2.7021, 2.9031),
    ("1200x2000", torch.bfloat16): (0.6062, 1.0057, 2.8428, 3.1736),
    ("1600x2666", torch.float32): (1.0505, 1.5512, 4.7404, 5.1622),
    ("1600x2666", torch.bfloat16): (1.0505, 1.6985, 4.9215, 5.5889),
    ("2560x4266", torch.float32): (1.3670, 2.0591, 5.9388, 6.5994),
    ("2560x4266", torch.bfloat16): (1.3583, 2.1531, 6.1889, 7.1260),
    ("3200x5332", torch.float32): (2.1222, 3.3621, 9.0170, 10.2431),
    ("3200x5332", torch.bfloat16): (2.1060, 3.4218, 9.5627, 11.1284),
}
SWEEP_SHAPES = {"base 64": _square(64), "base 128": _square(128),
                "base 256": _square(256), "base 512": _square(512),
                "800x1333": _model(800, 1333), "1200x2000": _model(1200, 2000),
                "1600x2666": _model(1600, 2666),
                "2560x4266": _model(2560, 4266),
                "3200x5332": _model(3200, 5332)}


@pytest.mark.parametrize("point,dtype", sorted(SWEEP, key=str), ids=str)
def test_op_dispatch_follows_the_sweep(recorded, point, dtype):
    """At every point of the sweep an unforced call runs K1 and K2, the
    faster calls on the model's points everywhere; uniform points from the
    256-base pyramid up, where the streamed backward ran faster, lose what
    PERF.md records (< 26%)."""
    k1, k3, k2, k45 = SWEEP[(point, dtype)]
    assert k1 < k3
    bwd_loss = k2 / min(k2, k45) - 1
    limit = 0.26 if point in ("base 256", "base 512") else 0.0
    assert bwd_loss <= limit, (point, dtype, bwd_loss)
    shapes = SWEEP_SHAPES[point]
    if point.startswith("base"):
        B, N = 4, 10_000
    else:  # encoder layer 0's call: every pixel a query
        B, N = (1 if point in ("2560x4266", "3200x5332") else 2,
                sum(h * w for h, w in shapes))
    inputs, out, grads = _op_calls(shapes, dtype, B, N)
    _assert_reached(recorded, "msda_fwd", "msda_bwd", shapes, inputs)
    assert (out, grads) == ("msda_fwd", "msda_bwd")


@pytest.mark.parametrize("shapes", [REF, DETR, BIG],
                         ids=["ref", "detr", "big"])
def test_unforced_op_calls_never_reach_the_streamed_kernels(recorded, shapes):
    """The reference, Deformable DETR 800x1333 and 256-base pyramids, every
    padding mode, f32 and bf16: K1 and K2 with the call's own arguments,
    and no streamed wrapper."""
    for dtype in (torch.float32, torch.bfloat16):
        for mode in MODES:
            recorded.clear()
            inputs, _, _ = _op_calls(shapes, dtype, 2, 300, mode)
            _assert_reached(recorded, "msda_fwd", "msda_bwd", shapes,
                            inputs, mode)


def test_forced_routes_everything_and_restores(recorded):
    """Under ``stream.forced()`` both directions reach the streamed
    wrappers with the arguments K1 and K2 get; ``FORCE`` is restored on
    leaving the block, also when the block raises."""
    assert not stream.FORCE
    with stream.forced():
        inputs, out, grads = _op_calls(REF, torch.float32, 2, 300)
    _assert_reached(recorded, "msda_stream_fwd", "msda_stream_bwd", REF,
                    inputs)
    assert (out, grads) == ("msda_stream_fwd", "msda_stream_bwd")
    assert not stream.FORCE
    with pytest.raises(RuntimeError, match="inside"):
        with stream.forced():
            assert stream.FORCE
            raise RuntimeError("inside the block")
    assert not stream.FORCE
    recorded.clear()
    _op_calls(REF, torch.float32, 2, 300)
    assert [name for name, _ in recorded] == ["msda_fwd", "msda_bwd"]


def test_op_on_cpu_is_reference_even_when_forced():
    img, shapes, pts, wts, _ = get_functional_data(N=30, P=3, seed=11)
    ti, tp, tw = _torch(img, pts, wts)
    before = dict(cuda_stream.LAUNCHES)
    with stream.forced():
        out = multiscale_deformable_attention(ti, shapes, tp, tw)
    assert torch.equal(out, native_multiscale_deformable_attention(
        ti, shapes, tp, tw))
    assert cuda_stream.LAUNCHES == before


def test_streamed_wrappers_refuse_cpu_tensors():
    img, shapes, pts, wts, og = get_functional_data(N=30, P=3, seed=12)
    ti, tp, tw, tog = _torch(img, pts, wts, og)
    before = dict(cuda_stream.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_stream.msda_stream_fwd(ti, shapes, tp, tw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_stream.msda_stream_bwd(ti, shapes, tp, tw, tog)
    assert cuda_stream.LAUNCHES == before


def test_reference_workload():
    img, shapes, pts, wts, og = reference_workload(50, seed=3)
    assert shapes == REF
    I = sum(h * w for h, w in REF)  # noqa: E741
    assert img.shape == (4, I, 8, 32) and og.shape == (4, 50, 8, 32)
    assert pts.shape == (4, 50, 8, 4, 4, 2) and wts.shape == (4, 50, 8, 4, 4)
    assert all(t.dtype == torch.float32 for t in (img, pts, wts, og))
    torch.testing.assert_close(wts.sum(-1), torch.ones(4, 50, 8, 4))
    assert 0 <= pts.min() and pts.max() < 1 and 0 <= og.min() and og.max() < 1
    again = reference_workload(50, seed=3)
    assert all(torch.equal(a, b) for a, b in
               zip((img, pts, wts, og), again[:1] + again[2:]))
    other = reference_workload(50, seed=4)
    assert not torch.equal(img, other[0])
    half = reference_workload(10, torch.bfloat16, BIG[2:], batch=1, heads=2,
                              channels=8, points=3)
    assert half[0].dtype == torch.bfloat16 and half[0].shape == (1, 5120, 2, 8)
    assert half[3].shape == (1, 10, 2, 2, 3)


def test_timeit_op_and_memory_stats_on_the_cpu():
    t = timeit_op(lambda: torch.ones(10).sum(), n=3, repeats=2, device="cpu")
    assert 0 < t < 1
    with pytest.raises(ValueError, match="n >= 1"):
        timeit_op(lambda: None, n=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA devices"):
        device_memory_stats("cpu")


def test_benchmark_writes_the_jax_columns(tmp_path):
    out = tmp_path / "bench.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "msda_tpu_torch.benchmark", "--device", "cpu",
         "--impls", "reference", "--queries", "10", "--no-memory",
         "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    # the JAX script's columns first, then the device that measured them
    assert list(rows[0]) == ["impl", "dtype", "num_queries", "fwd_ms",
                             "fwdbwd_ms", "peak_mem_mb", "device",
                             "power_limit"]
    assert (rows[0]["device"], rows[0]["power_limit"]) == ("cpu", "")
    assert [(r["impl"], r["dtype"], r["num_queries"]) for r in rows] == [
        ("reference", "float32", "10")]
    assert float(rows[0]["fwd_ms"]) > 0 and float(rows[0]["fwdbwd_ms"]) > 0


@pytest.mark.parametrize("argv", [
    ["--device", "cpu", "--impls", "cuda", "--no-memory"],
    ["--device", "cpu", "--impls", "reference"],
], ids=["cuda_on_cpu", "memory_on_cpu"])
def test_benchmark_refuses_what_the_cpu_cannot_measure(argv):
    with pytest.raises(SystemExit):
        benchmark.main(argv + ["--queries", "10"])
