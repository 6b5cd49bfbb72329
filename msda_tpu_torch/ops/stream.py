"""The large-pyramid path: band plan, L2 router and plain streamed versions.

The counterpart of ``msda_tpu/ops/pallas_stream.py``.  On the TPU the
streamed kernels K3-K5 exist because the resident kernels stage the whole
per-(b, h) pyramid in VMEM, which a large base level overflows; they cut
each level into row bands and stream one band at a time.  On an H100 the
resident gather kernels (K1, K2) have no such ceiling, but their gathers
and atomics miss the 50 MB L2 once one image's pyramid outgrows it.  The
streamed CUDA kernels (``cuda_stream.py``, ``csrc/msda_stream.cu``) keep
the band decomposition and drop the rest of the TPU form (the E/A matrices,
the bf16 splits, the padded pitch, the VMEM footprint model): a block
stages one **tile** of a level in shared memory and serves the sampling
points whose top-left corner lies in it; the backward adds its ``img_grad``
terms with vector atomics into the tile's rows of a zeroed f32 buffer,
which stay in L2 while the tile is served.

Tiles.  A level of ``h x w`` pixels is cut into bands of ``yb`` rows and,
where a row is too wide for shared memory, into columns of ``xb`` pixels.
A point belongs to the tile that holds its clamped top-left corner
``(y0c, x0c)`` (the band key; the same clamped corner ``msda::corner_geometry``
gives the kernels).  Its other corners are at most one row below and one
column right, so a tile is staged with one **halo** row and one halo column
(where the level goes on): ``min(yb + 1, h - y0)`` rows by
``min(xb + 1, w - x0)`` columns.

The band plan (:func:`band_plan`) derives ``(yb, xb)`` from the shared
memory of one tile (``TILE_BYTES``, 44 KiB), where both kernels stage the
tile in img's dtype: a block keeps a ring of two tiles (one served, the
next one copied in) beside its slice buffers, and an SM holds two blocks.
A level that fits stays whole; otherwise full-width bands of at least
``MIN_BAND_ROWS`` rows; otherwise bands of ``MIN_BAND_ROWS`` rows cut into
columns.  A level whose tile cannot hold even two columns raises.

The router (:func:`use_streaming_fwd` / :func:`use_streaming_bwd`, the
counterparts of ``pallas_stream.use_streaming_fwd`` :130 / ``_bwd`` :143)
is fitted to whole calls timed on the card (``chip_smoke.py`` phase 7d;
``PERF.md``), not a port of the VMEM model.  It cannot see the points, so
where the model's own points and uniform ones disagree it follows the
model's.  Measured on an H100 (50 MiB L2), from the reference pyramid to
the 512-base one and on the full-width model's own points from 800x1333
to 3200x5332 (one image's f32 pyramid and gradient 46 to 726 MB): the
streamed forward with its binning took 1.5-2.3x K1's time everywhere; the
streamed backward took 2-17% more than K2 on the model's points
everywhere, while on uniform points at the 256- and 512-base pyramids K2
took 11-25% more.  The model's neighbouring queries share pixels, so K1
and K2 keep hitting the L2 far past its size.  So neither direction
streams unless ``FORCE`` (or :func:`forced`) routes every call to the
streamed kernels, the counterpart of
``scripts/benchmark.py:_force_stream``.

The plain versions (:func:`plain_stream_fwd`, :func:`plain_stream_bwd`)
compute what the kernels compute with the same banding: the same keys,
staged tiles with their halos, and corner values read through tile-local
indices.  They run on any device, per level, in f32 (f64 for f64 points);
the point-gradient channel sums are in f64.  The tests hold them against the JAX ``stream_fwd`` / ``stream_bwd``
and the port's gather versions; ``chip_smoke.py`` holds the kernels
against them.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .reference import _geometry, level_shapes

__all__ = [
    "TILE_BYTES",
    "MIN_BAND_ROWS",
    "FORCE",
    "band_plan",
    "pyramid_plan",
    "check_plan",
    "tile_bytes",
    "num_bins",
    "use_streaming_fwd",
    "use_streaming_bwd",
    "l2_bytes",
    "forced",
    "sample_bins",
    "plain_stream_fwd",
    "plain_stream_bwd",
]

#: shared memory of one staged tile (``csrc/msda_stream.cu``
#: STREAM_TILE_BYTES): two blocks an SM, each with a ring of two tiles and
#: 24.1 KB of slice buffers, fill the SM's 228 KB
TILE_BYTES = 45_056
#: the shortest band a plan cuts before it cuts columns instead
MIN_BAND_ROWS = 8
#: route every call to the streamed kernels (tests, ``--force-stream``)
FORCE = False


def _pixel_bytes(C: int, dtype) -> int:
    """Shared memory per staged pixel: C channels in img's dtype."""
    return C * torch.empty((), dtype=dtype).element_size()


def _staged(h, w, yb, xb):
    """Rows and columns a tile of the plan stages, halos included."""
    return min(yb + 1, h), min(xb + 1, w)


def tile_bytes(h, w, yb, xb, C, dtype) -> int:
    """Shared memory the largest tile of the level takes."""
    rows, cols = _staged(h, w, yb, xb)
    return rows * cols * _pixel_bytes(C, dtype)


def band_plan(h: int, w: int, C: int, dtype) -> tuple[int, int]:
    """``(yb, xb)``: band rows and tile columns for a level of ``h x w``.

    ``yb >= h`` means one band, ``xb >= w`` full-width bands.  Raises
    ``ValueError`` when a tile of two columns does not fit ``TILE_BYTES``.
    """
    if h < 1 or w < 1 or C < 1:
        raise ValueError(f"cannot plan a level of {h}x{w} with C={C}")
    px = _pixel_bytes(C, dtype)
    max_px = TILE_BYTES // px
    if h * w <= max_px:
        return h, w
    if max_px // w - 1 >= MIN_BAND_ROWS:
        return max_px // w - 1, w
    yb = min(h, MIN_BAND_ROWS)
    rows = min(yb + 1, h)
    xb = max_px // rows - 1
    if xb < 1:
        raise ValueError(
            f"cannot plan the streamed kernels for a {h}x{w} level with "
            f"C={C} in {dtype}: a tile of {rows} rows x 2 columns needs "
            f"{rows * 2 * px} bytes of shared memory, more than the "
            f"{TILE_BYTES} of a tile")
    return yb, xb


def pyramid_plan(img_shapes, C: int, dtype):
    """:func:`band_plan` of every level: ``((yb, xb), ...)``."""
    return tuple(band_plan(h, w, C, dtype)
                 for h, w in level_shapes(img_shapes))


def check_plan(img_shapes, plan, C: int, dtype):
    """The plan for ``img_shapes``: :func:`pyramid_plan` when ``plan`` is
    None, else ``plan`` validated (one ``(yb, xb)`` of positive ints per
    level, each tile within ``TILE_BYTES``) as a tuple."""
    shapes = level_shapes(img_shapes)
    if plan is None:
        return pyramid_plan(shapes, C, dtype)
    plan = tuple((int(yb), int(xb)) for yb, xb in plan)
    if len(plan) != len(shapes) or any(min(p) < 1 for p in plan):
        raise ValueError(f"a plan needs one (yb, xb) >= 1 per level of "
                         f"{shapes}, got {plan}")
    for (h, w), (yb, xb) in zip(shapes, plan):
        need = tile_bytes(h, w, yb, xb, C, dtype)
        if need > TILE_BYTES:
            raise ValueError(f"a tile of plan {(yb, xb)} on a {h}x{w} level "
                             f"needs {need} bytes of shared memory, more "
                             f"than {TILE_BYTES}")
    return plan


def num_bins(img_shapes, plan) -> int:
    """Tiles of one (b, h): the bins the samples are sorted into."""
    return sum(-(-h // yb) * -(-w // xb)
               for (h, w), (yb, xb) in zip(level_shapes(img_shapes), plan))


def use_streaming_fwd(img_shapes, heads, channels, dtype, l2: int) -> bool:
    """Stream the forward of a call on these pyramid shapes, heads,
    channels and img dtype on a card of ``l2`` bytes of L2: only when
    ``FORCE`` is set, since K1 was the faster at every pyramid measured."""
    del img_shapes, heads, channels, dtype, l2
    return FORCE


def use_streaming_bwd(img_shapes, heads, channels, dtype, l2: int) -> bool:
    """As :func:`use_streaming_fwd`, for the backward: only when ``FORCE``
    is set, since K2 was the faster on the model's own points at every
    size measured."""
    del img_shapes, heads, channels, dtype, l2
    return FORCE


@functools.lru_cache(maxsize=None)
def _l2_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).L2_cache_size


def l2_bytes(device) -> int:
    """The L2 cache size of a CUDA device, in bytes."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the router needs a CUDA device, got {device}")
    return _l2_of(torch.cuda.current_device() if device.index is None
                  else device.index)


@contextlib.contextmanager
def forced(enabled: bool = True):
    """Set ``FORCE`` for the ``with`` block and restore it afterwards."""
    global FORCE
    before, FORCE = FORCE, enabled
    try:
        yield
    finally:
        FORCE = before


class _LevelTiles:
    """The tiles of one level under a plan, and where a point lands."""

    def __init__(self, h, w, yb, xb):
        self.h, self.w, self.yb, self.xb = h, w, yb, xb
        self.nrb, self.ncb = -(-h // yb), -(-w // xb)
        self.rows, self.cols = _staged(h, w, yb, xb)  # largest tile
        self.origins = [(r * yb, c * xb) for r in range(self.nrb)
                        for c in range(self.ncb)]

    def key(self, y0c, x0c):
        """Tile of the clamped top-left corner."""
        return (y0c // self.yb) * self.ncb + x0c // self.xb

    def extent(self, y0, x0):
        return min(self.rows, self.h - y0), min(self.cols, self.w - x0)

    def stage(self, level):
        """``level`` ``[B, H, h, w, C]`` -> the staged tiles
        ``[B, H, T * rows * cols, C]`` (halos included, zero padding)."""
        B, H, _, _, C = level.shape
        tiles = level.new_zeros(B, H, len(self.origins), self.rows,
                                self.cols, C)
        for t, (y0, x0) in enumerate(self.origins):
            r, c = self.extent(y0, x0)
            tiles[:, :, t, :r, :c] = level[:, :, y0:y0 + r, x0:x0 + c]
        return tiles.reshape(B, H, -1, C)

    def local(self, tile, y, x):
        """Index into the staged tiles of pixel (y, x) of ``tile``."""
        y0 = (tile // self.ncb) * self.yb
        x0 = (tile % self.ncb) * self.xb
        return (tile * self.rows + (y - y0)) * self.cols + (x - x0)


def _level_corners(corners, l, off, w):
    """Rows and columns of the four corners of level ``l``'s points."""
    i00, i01, i10, _ = (c[:, :, :, l] - off for c in corners)
    return i00 // w, i00 % w, i10 // w, i01 % w  # y0c, x0c, y1c, x1c


def sample_bins(sampling_points, img_shapes, plan, align_corners=False):
    """The bin of every sample, ``[B, N, H, L, P]`` int64: the plain version
    of the streamed kernels' binning.  Bin ``(b * H + h) * num_bins +
    (tiles of the levels before l) + key``, with the key of the clamped
    top-left corner (the same in both padding modes)."""
    shapes = level_shapes(img_shapes)
    B, N, H, L, P, _ = sampling_points.shape
    corners, _, _, _ = _geometry(shapes, sampling_points, "border",
                                 align_corners, sampling_points.device)
    bins = torch.empty((B, N, H, L, P), dtype=torch.int64,
                       device=sampling_points.device)
    off = first = 0
    for l, ((h, w), (yb, xb)) in enumerate(zip(shapes, plan)):
        tiles = _LevelTiles(h, w, yb, xb)
        y0c, x0c, _, _ = _level_corners(corners, l, off, w)
        bins[:, :, :, l] = first + tiles.key(y0c, x0c)
        off += h * w
        first += len(tiles.origins)
    bh = (torch.arange(B, device=bins.device)[:, None] * H
          + torch.arange(H, device=bins.device)[None, :])
    return bins + (bh * first)[:, None, :, None, None]


def _sampled(img, shapes, plan, sampling_points, padding_mode,
             align_corners, dtype):
    """Per level: for every point its corners' (row, column), lerp factors,
    masks and corner values (``[B, N, H, P, C]`` in ``dtype``), read through
    tile-local indices from the staged tiles."""
    B, _, H, C = img.shape
    N, P = sampling_points.shape[1], sampling_points.shape[4]
    corners, dx, dy, masks = _geometry(shapes, sampling_points, padding_mode,
                                       align_corners, img.device)
    img_t = img.permute(0, 2, 1, 3)  # [B, H, I, C]
    off = 0
    for l, ((h, w), (yb, xb)) in enumerate(zip(shapes, plan)):
        tiles = _LevelTiles(h, w, yb, xb)
        level = img_t[:, :, off:off + h * w].reshape(B, H, h, w, C)
        staged = tiles.stage(level)
        y0c, x0c, y1c, x1c = _level_corners(corners, l, off, w)
        key = tiles.key(y0c, x0c)
        idx = [tiles.local(key, y, x) for y, x in
               ((y0c, x0c), (y0c, x1c), (y1c, x0c), (y1c, x1c))]

        def gather(i):
            i = i.permute(0, 2, 1, 3).reshape(B, H, N * P, 1)
            g = torch.gather(staged, 2, i.expand(B, H, N * P, C))
            return g.reshape(B, H, N, P, C).permute(0, 2, 1, 3, 4)

        d_x = dx[:, :, :, l].to(dtype)  # [B, N, H, P, 1]
        d_y = dy[:, :, :, l].to(dtype)
        if masks is None:
            m = (1.0,) * 4
        else:
            m = tuple(k[:, :, :, l].to(dtype) for k in masks)
        my0, mx0, my1, mx1 = m
        lerp = (mx0 * (1 - d_x), mx1 * d_x, my0 * (1 - d_y), my1 * d_y)
        values = [gather(i).to(dtype) for i in idx]
        corner_pixels = ((y0c, x0c), (y0c, x1c), (y1c, x0c), (y1c, x1c))
        yield l, corner_pixels, lerp, (mx0, mx1, my0, my1), values
        off += h * w


def plain_stream_fwd(img, img_shapes, sampling_points, attention_weights,
                     padding_mode="border", align_corners=False, plan=None):
    """The streamed forward with its banding, in plain PyTorch.

    Same arguments and result as
    ``reference.native_multiscale_deformable_attention``; ``plan`` (default
    :func:`pyramid_plan`) is one ``(yb, xb)`` per level.  Each tile's points
    read their corners from the staged tile (halo row and column included)
    and add ``a * bilerp`` into an f32 (f64 for f64 points) sum, rounded once
    to ``img.dtype``.
    """
    shapes = level_shapes(img_shapes)
    plan = check_plan(shapes, plan, img.shape[3], img.dtype)
    dtype = torch.promote_types(sampling_points.dtype, torch.float32)
    B, _, H, C = img.shape
    out = torch.zeros((B, sampling_points.shape[1], H, C), dtype=dtype,
                      device=img.device)
    for l, _, lerp, _, v in _sampled(img, shapes, plan, sampling_points,
                                     padding_mode, align_corners, dtype):
        vx0, vx1, uy0, uy1 = lerp
        a = attention_weights[:, :, :, l].to(dtype)[..., None]
        out += (a * (uy0 * (vx0 * v[0] + vx1 * v[1])
                     + uy1 * (vx0 * v[2] + vx1 * v[3]))).sum(3)
    return out.to(img.dtype)


def plain_stream_bwd(img, img_shapes, sampling_points, attention_weights,
                     out_grad, padding_mode="border", align_corners=False,
                     plan=None):
    """The streamed backward with its banding, in plain PyTorch.

    Returns ``(img_grad, sampling_points_grad, attention_weights_grad)`` in
    the dtypes of the three inputs, as ``reference.native_msda_backward``
    does.  Per sample, with the corner values read from its staged tile:
    ``wts_grad = sum_c og * sample`` and the ``img_grad`` terms, added into
    the level, in f32 (f64 for f64 points); the point gradients
    ``a * scale * sum_c og * d sample`` with their channel sums in f64.
    ``plan`` defaults to :func:`pyramid_plan`.
    """
    shapes = level_shapes(img_shapes)
    plan = check_plan(shapes, plan, img.shape[3], img.dtype)
    dtype = torch.promote_types(sampling_points.dtype, torch.float32)
    f64 = torch.float64
    B, _, H, C = img.shape
    N, L, P = (sampling_points.shape[i] for i in (1, 3, 4))
    og = out_grad.to(dtype)[:, :, :, None]  # [B, N, H, 1, C]
    og64 = og.to(f64)
    img_grad = torch.zeros((B, H, img.shape[1], C), dtype=dtype,
                           device=img.device)
    pts_grad = torch.empty((B, N, H, L, P, 2), dtype=f64, device=img.device)
    wts_grad = torch.empty((B, N, H, L, P), dtype=dtype, device=img.device)
    off = 0
    for l, corner_pixels, lerp, m, v in _sampled(
            img, shapes, plan, sampling_points, padding_mode, align_corners,
            dtype):
        h, w = shapes[l]
        vx0, vx1, uy0, uy1 = lerp
        mx0, mx1, my0, my1 = m
        a = attention_weights[:, :, :, l].to(dtype)[..., None]
        sample = uy0 * (vx0 * v[0] + vx1 * v[1]) + uy1 * (vx0 * v[2]
                                                          + vx1 * v[3])
        wts_grad[:, :, :, l] = (og * sample).sum(-1)
        d = [t.to(f64) for t in v]
        ddx = (uy0.to(f64) * (mx1 * d[1] - mx0 * d[0])
               + uy1.to(f64) * (mx1 * d[3] - mx0 * d[2]))
        ddy = (my1 * (vx0.to(f64) * d[2] + vx1.to(f64) * d[3])
               - my0 * (vx0.to(f64) * d[0] + vx1.to(f64) * d[1]))
        a64 = a[..., 0].to(f64)
        scale = (w - 1, h - 1) if align_corners else (w, h)
        pts_grad[:, :, :, l, :, 0] = a64 * scale[0] * (og64 * ddx).sum(-1)
        pts_grad[:, :, :, l, :, 1] = a64 * scale[1] * (og64 * ddy).sum(-1)

        level_grad = img_grad[:, :, off:off + h * w]
        ao = a * og
        for (y, x), u in zip(corner_pixels, (uy0 * vx0, uy0 * vx1,
                                              uy1 * vx0, uy1 * vx1)):
            i = (y * w + x).permute(0, 2, 1, 3).reshape(B, H, N * P, 1)
            src = (ao * u).permute(0, 2, 1, 3, 4).reshape(B, H, N * P, C)
            level_grad.scatter_add_(2, i.expand(B, H, N * P, C), src)
        off += h * w
    return (img_grad.permute(0, 2, 1, 3).to(img.dtype),
            pts_grad.to(sampling_points.dtype),
            wts_grad.to(attention_weights.dtype))
