"""Wrapper of K1's prologue variant, ``msda_fwd_queries`` in
``csrc/msda_fwd.cu``.

The attention module (``models/attention.py``) turns the query
projection's output ``q`` ``[B, N, H, L, P, 3]`` (each point's x and y
offsets and its attention logit) into K1's sampling points and attention
weights by a chain of PyTorch calls: ``q`` up-cast to at least f32, a
softmax of the logits over the L * P points of a head, the offsets divided
by the level's size (2-coordinate reference points) or scaled by the box
(4-coordinate ones), and added to the reference point.  The variant is K1
started from ``q`` itself: it computes that softmax and those locations in
shared memory, in the chain's f32 operations and order, and nothing goes to
device memory between the projection and the gather (the note in the
source says how).  Its plain version is that chain followed by the plain
MSDA, ``msda_fwd_queries_plain``, which is also the CPU implementation of
the operator ``torch.ops.msda_tpu_torch.msda_fwd_queries``
(``library.py``); the chain alone is ``sampling_plain``, which the module
runs wherever the variant is not taken.

The variant takes 3 to 32 points a head (a task's points are its
softmax's lanes, a point a lane), rows of ``q`` that 4-byte copies divide
(any f32 row; an even L * P in the half types) and a tile that fits a
block's shared memory: ``takes`` says so from the shapes alone, and the
module sends it nothing else.

The wrapper checks device, dtype, shape and layout and raises on anything
the kernel does not take; it never falls back to the plain version.  The
reference points may be any float dtype (cast to f32, exactly, as the
chain's promotion casts them) and any batch and query strides, a batch
stride of 0 included, but their last axis must be contiguous.  The output
has ``img``'s dtype.  The library is K1's (``cuda_fwd.load``), and each
launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_fwd, launches
from .reference import level_shapes, native_multiscale_deformable_attention

__all__ = ["KERNEL", "LAUNCHES", "NORMALIZERS", "PLAN_FIELDS", "takes",
           "sampling_plain", "msda_fwd_queries_plain", "msda_fwd_queries",
           "launch_plan", "load"]

KERNEL = "msda_fwd_queries"
NORMALIZERS = ("reference", "detr")
# msda::FwdQueriesPlan's fields, in the order msda_fwd_queries_plan writes
# them
PLAN_FIELDS = ("lanes", "vec", "tile", "stride", "q_bytes", "ref_floats",
               "smem")
# csrc/msda_fwd_plan.cuh's MSDA_FWD_WARPS, MSDA_FWD_STAGES and
# MSDA_FWD_SMEM_MAX in the library as it is built (no -D flag)
WARPS, STAGES, SMEM_MAX = 4, 3, 231424

# Number of kernel launches since import (or since a caller reset it).
LAUNCHES = 0
launches.register(__name__)


def load() -> ctypes.CDLL:
    """Build (if needed) and load K1's library; set the variant's
    signatures."""
    lib = cuda_fwd.load()
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.msda_fwd_queries_launch.argtypes = [
        ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cl, cl, ci,
        ci, ci, vp]
    lib.msda_fwd_queries_launch.restype = ci
    lib.msda_fwd_queries_plan.argtypes = [ci, vp, vp, vp, cl, cl, ci, ci, ci,
                                          ci, vp]
    lib.msda_fwd_queries_plan.restype = ci
    return lib


def takes(img: torch.Tensor, q: torch.Tensor) -> bool:
    """Whether the variant takes ``img`` ``[B, I, H, C]`` and ``q`` ``[B,
    N, H, L, P, 3]``: ``msda::fwd_queries_plan``'s rule, read from their
    shapes, dtype and storage offsets alone, so that a traced or exported
    module decides as a live one does.  3 to 32 points a head, rows of
    ``q`` that 4-byte copies divide, and the tile in a block's shared
    memory, taken at 4 channels a lane where C allows it (the larger tile:
    with one channel a lane it fits too)."""
    L, P = q.shape[3], q.shape[4]
    LP, elem, C = L * P, q.element_size(), img.shape[-1]
    if not 3 <= LP <= 32 or (3 * LP * elem) % 4 or (
            q.storage_offset() * elem) % 4:
        return False
    vec = 4 if C % 4 == 0 else 1
    lanes = 1  # msda::group_lanes
    while lanes * vec < C and lanes < 32:
        lanes <<= 1
    stride = 1 << (LP - 1).bit_length()
    return WARPS * 32 // lanes * (
        stride * (32 + 3 * elem * STAGES) + 16 * STAGES) <= SMEM_MAX


def sampling_plain(q: torch.Tensor, reference_points: torch.Tensor,
                   img_shapes, offset_normalizer: str = "reference",
                   hw: torch.Tensor | None = None):
    """The chain: ``q`` ``[B, N, H, L, P, 3]`` and the reference points
    ``[B, N, 2]`` (normalized (x, y)) or ``[B, N, 4]`` (normalized (cx, cy,
    w, h) boxes) to the sampling points ``[B, N, H, L, P, 2]`` and the
    attention weights ``[B, N, H, L, P]``, in at least f32.

    Offsets and logits are taken in at least f32 even under bf16, since
    bf16's 8 mantissa bits would quantize absolute sampling positions to
    ~1/256 of a level (promoted, so that f64 stays f64).  2-coordinate
    offsets are divided by the level's (height, width) (``"reference"``,
    msda-triton's order: x by the height) or (width, height) (``"detr"``);
    ``hw`` is the levels' (height, width) as a tensor of the offsets' dtype
    on their device, made here when not given.  4-coordinate offsets are
    scaled by the box's size over 2P.
    """
    q = q.to(torch.promote_types(q.dtype, torch.float32))
    B, N, H, L, P, _ = q.shape
    offsets, logits = q[..., :2], q[..., 2]
    attention_weights = torch.softmax(
        logits.reshape(B, N, H, L * P), dim=-1
    ).reshape(B, N, H, L, P)
    last = reference_points.shape[-1]
    if last == 2:
        if hw is None:  # (h, w) order
            hw = torch.tensor(level_shapes(img_shapes), dtype=offsets.dtype,
                              device=offsets.device)
        normalizer = hw if offset_normalizer == "reference" else hw.flip(-1)
        # [B, N, 1, 1, 1, 2] + [B, N, H, L, P, 2] / [L, 1, 2]
        sampling_points = (
            reference_points[:, :, None, None, None, :]
            + offsets / normalizer[:, None, :]
        )
    elif last == 4:
        # box-scaled offsets
        sampling_points = (
            reference_points[:, :, None, None, None, :2]
            + offsets
            * reference_points[:, :, None, None, None, 2:]
            / (2 * P)
        )
    else:
        raise ValueError(
            "`reference_points` should have last dim 2 or 4, "
            f"but got {last}."
        )
    return sampling_points, attention_weights


def msda_fwd_queries_plain(img, img_shapes, q, reference_points,
                           offset_normalizer: str = "reference",
                           padding_mode: str = "border",
                           align_corners: bool = False) -> torch.Tensor:
    """What the kernel computes, as the chain and the plain MSDA:
    ``[B, N, H, C]`` in ``img``'s dtype."""
    shapes = level_shapes(img_shapes)
    points, weights = sampling_plain(q, reference_points, shapes,
                                     offset_normalizer)
    return native_multiscale_deformable_attention(
        img, shapes, points, weights, padding_mode, bool(align_corners))


def check_inputs(img, img_shapes, q, reference_points, offset_normalizer,
                 padding_mode):
    """Validate the kernel's inputs.  Returns ``(level_hw, ref)``: the level
    shapes as a ctypes ``int[L * 2]`` array for the launch, and the
    reference points in f32.  Raises ``ValueError`` on anything the kernel
    does not take."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(
            f"padding_mode must be 'border' or 'zeros', got {padding_mode!r}")
    if offset_normalizer not in NORMALIZERS:
        raise ValueError(f"offset_normalizer must be one of {NORMALIZERS}, "
                         f"got {offset_normalizer!r}")
    if img.dtype not in cuda_fwd.DTYPE_CODES or q.dtype != img.dtype:
        raise ValueError(
            "the CUDA kernel takes img and q of one dtype, bf16, f16 or f32, "
            f"got {img.dtype} and {q.dtype}")
    if reference_points.dtype not in cuda_fwd.DTYPE_CODES:
        raise ValueError("the CUDA kernel takes reference points in bf16, "
                         f"f16 or f32, got {reference_points.dtype}")
    tensors = (img, q, reference_points)
    if not all(t.is_cuda for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError(
            "the CUDA kernel needs img, q and reference_points on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}")
    if img.ndim != 4 or q.ndim != 6 or q.shape[-1] != 3:
        raise ValueError(
            "expected img [B, I, H, C] and q [B, N, H, L, P, 3], got "
            f"{tuple(img.shape)} and {tuple(q.shape)}")
    B, _, H, _ = img.shape
    Bq, N, Hq, L, P, _ = q.shape
    if (Bq, Hq) != (B, H) or reference_points.ndim != 3 or (
            tuple(reference_points.shape[:2]) != (B, N)
            or reference_points.shape[2] not in (2, 4)):
        raise ValueError(
            f"shape mismatch: img {tuple(img.shape)}, q {tuple(q.shape)}, "
            f"reference_points {tuple(reference_points.shape)} (expected "
            f"[{B}, {N}, 2 or 4])")
    level_hw = cuda_fwd.level_table(img_shapes, img, B * N * H, L, P)
    if not (img.is_contiguous() and q.is_contiguous()):
        raise ValueError("img and q must be contiguous")
    if not takes(img, q):
        raise ValueError(
            f"the variant takes 3 to 32 points a head and rows of q that "
            f"4-byte copies divide, got L * P = {L * P} in {q.dtype} at "
            f"element {q.storage_offset()} (the chain and K1 take any)")
    ref = reference_points.to(torch.float32)
    if ref.stride(-1) != 1:
        raise ValueError("the reference points' last axis must be "
                         "contiguous")
    return level_hw, ref


def msda_fwd_queries(img: torch.Tensor, img_shapes, q: torch.Tensor,
                     reference_points: torch.Tensor,
                     offset_normalizer: str = "reference",
                     padding_mode: str = "border",
                     align_corners: bool = False) -> torch.Tensor:
    """Launch the variant on ``torch.cuda.current_stream()``; returns
    ``[B, N, H, C]`` in ``img``'s dtype.

    ``img`` ``[B, I, H, C]`` and ``q`` ``[B, N, H, L, P, 3]`` are of one
    dtype, bf16, f16 or f32, and contiguous; ``reference_points`` is
    ``[B, N, 2]`` or ``[B, N, 4]`` as ``sampling_plain`` takes it.  Raises
    ``ValueError`` on inputs the kernel does not take and ``RuntimeError``
    when the build or the launch fails.
    """
    global LAUNCHES
    level_hw, ref = check_inputs(img, img_shapes, q, reference_points,
                                 offset_normalizer, padding_mode)
    B, I, H, C = img.shape  # noqa: E741
    _, N, _, L, P, _ = q.shape
    lib = load()
    out = torch.empty((B, N, H, C), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES += 1
        err = lib.msda_fwd_queries_launch(
            cuda_fwd.DTYPE_CODES[img.dtype], img.data_ptr(), q.data_ptr(),
            ref.data_ptr(), out.data_ptr(), ctypes.addressof(level_hw),
            B, I, N, H, C, L, P, ref.shape[-1], ref.stride(0), ref.stride(1),
            int(offset_normalizer == "detr"), int(padding_mode == "zeros"),
            int(bool(align_corners)), stream)
    if err != 0:
        raise RuntimeError(f"msda_fwd_queries_launch failed: CUDA error {err}")
    return out


def launch_plan(img, img_shapes, q, reference_points) -> dict:
    """The plan of the variant's launch on these inputs, ``{field: int}``
    over ``PLAN_FIELDS`` (``csrc/msda_fwd_plan.cuh``): the lanes, channels
    a lane and tile as ``cuda_fwd.launch_plan``'s, a task's entries (its
    softmax's lanes), the bytes a copy of q's rows, the floats a copy of a
    reference point, and the shared memory."""
    _, ref = check_inputs(img, img_shapes, q, reference_points, "reference",
                          "border")
    L, P = q.shape[3:5]
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    err = load().msda_fwd_queries_plan(
        cuda_fwd.DTYPE_CODES[img.dtype], img.data_ptr(), q.data_ptr(),
        ref.data_ptr(), ref.stride(0), ref.stride(1), img.shape[-1], L, P,
        ref.shape[-1], ctypes.addressof(plan))
    if err != 0:
        raise RuntimeError(f"msda_fwd_queries_plan failed: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, plan))
