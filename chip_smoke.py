#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``msda_tpu_torch``) once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; there is no CPU mode.  The phases:

1. Setup: print the card's name and power limit, turn TF32 off, build the
   CUDA kernels (K1 forward, K2 backward, and the streamed K3' forward and
   K4' + K5' backward with their binning) from ``msda_tpu_torch/csrc``, one
   ``nvcc`` per source, started together, and print the build time and each
   kernel's registers and spills.
2. Kernels vs plain versions: K1 against
   ``native_multiscale_deformable_attention`` and K2 against
   ``native_msda_backward`` on the same seeded inputs, at the reference
   workload, Deformable DETR's encoder and decoder shapes and a ragged N
   with out-of-bounds points; f32, bf16 and f16; every padding_mode x
   align_corners.
3. Model parity: the full-width Deformable DETR (box refinement, no
   two-stage, so that no top-k can flip on a near tie) with impl="cuda"
   against impl="reference", same weights, f32: the outputs, then the
   loss and every parameter's gradient (fixed matcher, so that no auction
   can flip on a near tie either).
4. Serving: the full-width two-stage model answers 3 requests of batch 2
   (forward + postprocess) in f32 and in bf16, under inference_mode; each
   forward must launch K1 12 times.
5. Training, the main path of the backward: the full-width two-stage model,
   batch 2, focal loss + auction matcher + aux and proposal losses, AdamW;
   one warm-up step and 5 steps on a fixed synthetic batch, in f32 and in
   bf16, then one step with remat=True.  Each step must launch K1 12 times
   (24 with remat) and K2 12 times; the losses must be finite and fall.
6. Timing: K1 and K2 against their plain versions, in turns, each beside
   its bound (``utils.bench.msda_bound``: the least time the card could
   take, from the bytes the call must move and the operations it must do,
   with ``img`` counted in the rows the points reach); then K1 and K2 alone
   at the 256-base pyramid (I = 87,040), beyond the card's L2.
7. The large-pyramid path (``ops/stream.py``, ``ops/cuda_stream.py``):
   a. the binning against ``stream.sample_bins``, and K3' and K4' + K5'
      against ``stream.plain_stream_fwd`` / ``plain_stream_bwd`` at the
      256-base pyramid (B=4, N=10,000), a small pyramid with several bands
      and column tiles per level (widths not multiples of 8), a ragged N
      with out-of-bounds points, a skewed case with every point in one
      band, encoder layer 0's call of the full-width model at 1600x2666
      (batch 1, the model's own points) and a coincident case with every
      point of a (b, h) at one place; f32, bf16 and f16; every
      padding_mode x align_corners;
   b. the refitted routes: ``multiscale_deformable_attention(impl="auto")``
      forward and backward at the 512-base pyramid, where the router keeps
      both directions on K1 and K2, and with ``stream.forced()`` at the
      256-base pyramid (both streamed); launches counted, results against
      the plain versions;
   c. K3' against K1 and K4' + K5' against K2, in turns with the plain
      versions, at the 256-base pyramid in f32 and bf16;
   d. the router's sweep: pyramid bases 64, 128, 256 and 512 (B=4,
      N=10,000, uniform points) and encoder layer 0's call of the full-width
      model at 800x1333, 1200x2000 and 1600x2666 (batch 2) and at 2560x4266
      and 3200x5332 (batch 1), f32 and bf16: streamed against resident
      calls, and the router's choice beside both;
   e. one ``--pyramid big`` run of ``python -m msda_tpu_torch.benchmark``
      at N=10,000.
8. Export and profiling (``ops/library.py``, ``utils/export.py``,
   ``utils/profile.py``):
   a. ``torch.library.opcheck`` of the operators
      ``torch.ops.msda_tpu_torch.msda_fwd`` and ``msda_bwd`` on CUDA
      tensors at the decoder's shapes, f32 and bf16, both paddings;
   b. the full-width two-stage model's forward + postprocess exported with
      ``utils.export.export_fn`` in f32 and bf16 and saved under
      ``build/export_smoke/``; a second Python process, which imports
      torch, numpy and ``msda_tpu_torch.utils.export`` only, loads the
      artifacts and serves phase 4's 3 requests (after a warm-up), each
      forward launching K1 12 times; its detections against the live
      model's (labels equal, scores and boxes within 1e-5 f32, 1e-2 bf16),
      its request times beside phase 4's;
   c. one f32 serving request and one f32 training step under
      ``utils.profile.trace``: the window, device busy time and idle
      share, the 10 kernels with the most device time, and the spans
      (encoder, decoder, postprocess; loss + matcher, backward,
      optimizer);
   d. ``python -m msda_tpu_torch.capture_trace --mode fwdbwd`` and
      ``python -m msda_tpu_torch.memory_report`` in-process at N=10,000.
9. The device mesh, detection parity and the launch-constant sweep:
   a. ``python -m msda_tpu_torch.dryrun --devices 8 --device cpu``: one
      sharded training step of a tiny model on 8 gloo ranks of the host;
   b. the full-width two-stage model on a one-rank NCCL mesh through the
      mesh path (``shard_params``, ``shard_map_multiscale_deformable_
      attention`` in every attention module, ``make_train_step(mesh=...)``)
      against the same model without a mesh: one request's detections
      (labels equal, scores and boxes within 1e-6) with 12 K1 a forward,
      then one f32 SGD step's loss and every updated parameter within 1e-6
      relative (of the tensor's largest value, at least 1e-3 of the
      model's largest), 12 K1 and 12 K2 a step;
   c. HF Deformable DETR and Grounding DINO at their published
      configurations (``detection_parity.run_parity(size="full")``), f32,
      stock against patched with the port's op: 12 K1 a patched forward,
      top-10 detections identical, boxes within 1e-3, each side's request
      time;
   d. ``autotune.sweep`` with two candidates a constant (K1/K2's
      ``MSDA_WARPS_PER_BLOCK``; the streamed kernels' ``STREAM_SLICE``,
      ``FWD_``/``BWD_CHUNKS_PER_BLOCK``), a short run: each variant builds,
      agrees with its plain version and is timed.
10. The headline lines: ``python -m msda_tpu_torch.headline`` in a
    subprocess must exit 0 with root ``bench.py``'s three lines (f32 and
    bf16 fwd+bwd, f32 fwd at N=10,000), each finite; they are printed
    beside the card's name and power limit, with K1's and K2's launches
    in that process.

Any failure raises, and the script exits non-zero.  The line before the
last is a JSON summary of the kernels (launches on the main paths, the
exported model's, the mesh path's, the HF models' and the headline's
included, and per
training step, error, time, plain time
and bound at the encoder shape for K1/K2 and at the 256-base pyramid for
the streamed kernels); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from msda_tpu_torch import autotune, benchmark, capture_trace, detection_parity, headline, memory_report  # noqa: E402
from msda_tpu_torch.models import DeformableDetr, attention, init_parameters, postprocess  # noqa: E402
from msda_tpu_torch.ops import _build, cuda_bwd, cuda_fwd, cuda_stream, library, stream  # noqa: E402
from msda_tpu_torch.ops import multiscale_deformable_attention as msda  # noqa: E402
from msda_tpu_torch.ops import native_msda_backward as plain_msda_bwd  # noqa: E402
from msda_tpu_torch.ops import native_multiscale_deformable_attention as plain_msda  # noqa: E402
from msda_tpu_torch.parallel import detection_loss, make_mesh, make_train_step, shard_params  # noqa: E402
from msda_tpu_torch.utils import (annotate, card_identity, export_fn,  # noqa: E402
                                  msda_bound, reference_workload, roofline_ms,
                                  save_exported, touched_rows, trace)

# Deformable DETR (Zhu et al., arXiv:2010.04159 §4, App. A): an 800x1333
# image at strides 8/16/32/64, ResNet-50 C3-C5 + one extra level.
SLICE_SHAPES = ((100, 167), (50, 84), (25, 42), (13, 21))
IN_CHANNELS = (512, 1024, 2048, 2048)
STRIDES = (8, 16, 32, 64)
IMAGE_HW = (800, 1333)
# inputs past 800x1333 (high-resolution detection): one image's f32
# pyramid is 51.1 MB at 1200x2000 and 90.9 MB at 1600x2666, past the L2
MODEL_SIZES = ((800, 1333), (1200, 2000), (1600, 2666))
BATCH = 2
# larger inputs, at batch 1: one image's f32 pyramid and gradient take 465
# and 726 MB, 9 and 14 times an H100's L2 (the 512-base pyramid: 713 MB)
LARGE_MODEL_SIZES = ((2560, 4266), (3200, 5332))
MODEL = dict(num_classes=91, in_channels=IN_CHANNELS, emb_dim=256,
             num_heads=8, num_points=4, num_queries=300,
             num_encoder_layers=6, num_decoder_layers=6, ffn_dim=1024,
             with_box_refinement=True)
LAUNCHES_PER_FORWARD = 12  # 6 encoder + 6 decoder layers
# the reference workload of the benchmarks (msda_tpu/utils/bench.py)
REF_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
# scripts/benchmark.py --pyramid big: I = 87,040, 356 MB of f32 img at B=4
BIG_SHAPES = ((256, 256), (128, 128), (64, 64), (32, 32))
# the 512-base pyramid, where the router streams the backward (phase 7b)
PATH_SHAPES = tuple((512 >> i, 512 >> i) for i in range(4))
# training: 50 target slots per image, a seeded ~7 of them real (COCO's
# mean); the Deformable DETR optimizer (AdamW, lr 2e-4, weight decay 1e-4)
TARGET_SLOTS = 50
TRAIN_STEPS = 5
LOSS_KW = dict(matcher="auction", class_loss="focal", aux_weight=1.0,
               enc_weight=1.0, l1_weight=5.0, giou_weight=2.0)

# kernel vs plain: |kernel - plain| <= tol * max(1, |plain|); about two ulps
# of the output type for the half types (both round an f32 sum once)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
MODEL_TOL = 1e-4
# K2 vs plain, relative to max(1, |plain|): both compute the point gradients
# exactly (f64 channel sums) on the same f32 geometry and the weight
# gradients as f32 channel sums; img_grad is an f32 atomic sum
# (run-dependent order) in K2, rounded once to the half types on both sides
POINT_GRAD_TOL = 1e-4
IMG_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
                torch.float16: 2e-3}
# full-width gradients, cuda vs reference: |diff| <= GRAD_TOL * scale, where
# scale is the tensor's largest gradient, but at least GRAD_FLOOR of the
# model's largest (a gradient that is zero in exact arithmetic, like the
# self-attention key bias's, holds rounding noise only)
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-3
MODES = [(p, a) for p in ("border", "zeros") for a in (False, True)]

DEVICE = torch.device("cuda")
STREAM_SOURCE = "msda_tpu_torch/csrc/msda_stream.cu"
KERNELS = {  # name: (module, source, TPU kernel(s) it replaces)
    cuda_fwd.KERNEL: (cuda_fwd, "msda_tpu_torch/csrc/msda_fwd.cu",
                      "msda_tpu/ops/pallas_fwd.py:440"),
    cuda_bwd.KERNEL: (cuda_bwd, "msda_tpu_torch/csrc/msda_bwd.cu",
                      "msda_tpu/ops/pallas_bwd.py:147"),
    "msda_stream_fwd": (cuda_stream, STREAM_SOURCE,
                        "msda_tpu/ops/pallas_stream.py:206"),
    # K4 and K5 are one CUDA kernel
    "msda_stream_bwd": (cuda_stream, STREAM_SOURCE,
                        "msda_tpu/ops/pallas_stream.py:330 + "
                        "msda_tpu/ops/pallas_stream.py:411"),
    # the band selection inside K3-K5 (_band_factors)
    "msda_stream_bin": (cuda_stream, STREAM_SOURCE,
                        "msda_tpu/ops/pallas_stream.py:187"),
}
LIBRARIES = (cuda_fwd.KERNEL, cuda_bwd.KERNEL, cuda_stream.LIBRARY)


def log(msg: str) -> None:
    print(msg, flush=True)


def setup() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; none is visible")
    name, limit = card_identity()
    if not limit:
        raise RuntimeError("nvidia-smi did not give the card's name and "
                           "power limit")
    smi = f"{name}, {limit}"  # as nvidia-smi prints it
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(list(LIBRARIES))
    for module in (cuda_fwd, cuda_bwd, cuda_stream):
        module.load()
    log(f"build: {', '.join(LIBRARIES)} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    # one register/spill report per kernel instantiation
    for name in LIBRARIES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def launches() -> dict:
    """Every kernel's launch count."""
    return {cuda_fwd.KERNEL: cuda_fwd.LAUNCHES,
            cuda_bwd.KERNEL: cuda_bwd.LAUNCHES, **cuda_stream.LAUNCHES}


def reset_launches() -> None:
    cuda_fwd.LAUNCHES = cuda_bwd.LAUNCHES = 0
    for name in cuda_stream.LAUNCHES:
        cuda_stream.LAUNCHES[name] = 0


def check_path_launches(path: str, counts: dict, expected: dict) -> None:
    """Fail unless the path launched exactly ``expected`` (and no other
    kernel)."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{path}: launches {counts}, expected {want}")


def op_inputs(shapes, B, N, H, C, P, seed, oob=False, out_grad=False):
    """Seeded numpy inputs on the card: img f32, points f32, weights f32
    (and an f32 out_grad [B, N, H, C] with ``out_grad=True``)."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    I = sum(h * w for h, w in shapes)  # noqa: E741
    img = rng.standard_normal((B, I, H, C), dtype=np.float32)
    pts = rng.random((B, N, H, L, P, 2), dtype=np.float32)
    if oob:
        pts = pts * 2.0 - 0.5
    logits = rng.standard_normal((B, N, H, L * P), dtype=np.float32)
    wts = np.exp(logits - logits.max(-1, keepdims=True))
    wts = (wts / wts.sum(-1, keepdims=True)).reshape(B, N, H, L, P)
    out = [torch.from_numpy(a).to(DEVICE) for a in (img, pts, wts)]
    if out_grad:
        out.append(torch.from_numpy(rng.standard_normal(
            (B, N, H, C), dtype=np.float32)).to(DEVICE))
    return out


OP_CASES = {
    "reference_workload": dict(shapes=REF_SHAPES, B=4, N=10000, H=8, C=32,
                               P=4, seed=0),
    "encoder": dict(shapes=SLICE_SHAPES, B=BATCH,
                    N=sum(h * w for h, w in SLICE_SHAPES), H=8, C=32, P=4,
                    seed=1),
    "decoder": dict(shapes=SLICE_SHAPES, B=BATCH, N=300, H=8, C=32, P=4,
                    seed=2),
    "ragged_oob": dict(shapes=REF_SHAPES, B=2, N=1037, H=8, C=32, P=4,
                       seed=3, oob=True),
}


def errors(got, want):
    diff = (got.float() - want.float()).abs()
    mixed = (diff / want.float().abs().clamp(min=1.0)).max().item()
    rel = (diff.max() / want.float().abs().max()).item()
    return diff.max().item(), rel, mixed


def bound(shapes, img, pts, wts, backward: bool) -> dict:
    """``msda_bound`` of one call on these inputs (border, align_corners
    False: the timed mode), with img counted in the rows the points
    reach."""
    B, N, H, L, P, _ = pts.shape
    return msda_bound(shapes, B, N, H, img.shape[-1], P, img.dtype,
                      backward, touched_rows(shapes, pts, wts))


def check_kernel() -> float:
    """Phase 2; returns the largest f32 abs error at the encoder shape."""
    enc_f32_err = 0.0
    for name, case in OP_CASES.items():
        img32, pts, wts = op_inputs(**case)
        for dtype, tol in TOL.items():
            img = img32.to(dtype)
            for padding_mode, align_corners in MODES:
                got = cuda_fwd.msda_fwd(img, case["shapes"], pts, wts,
                                        padding_mode, align_corners)
                torch.cuda.synchronize()
                want = plain_msda(img, case["shapes"], pts, wts,
                                  padding_mode, align_corners)
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{name}: kernel gave {got.shape} "
                                         f"{got.dtype}, plain {want.shape} "
                                         f"{want.dtype}")
                abs_err, rel_err, mixed = errors(got, want)
                ok = mixed <= tol and torch.isfinite(got).all().item()
                log(f"kernel {name:18s} {str(dtype)[6:]:8s} {padding_mode:6s}"
                    f" ac={int(align_corners)}: max_abs {abs_err:.3e} "
                    f"max_rel {rel_err:.3e} err {mixed:.3e} (tol {tol:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with the plain "
                                         f"version: {name} {dtype} "
                                         f"{padding_mode} ac={align_corners}")
                if name == "encoder" and dtype == torch.float32:
                    enc_f32_err = max(enc_f32_err, abs_err)
        del img32, pts, wts
    return enc_f32_err


def check_backward_kernel() -> float:
    """Phase 2, K2; returns the largest f32 abs error (over the three
    gradients) at the encoder shape."""
    enc_f32_err = 0.0
    for name, case in OP_CASES.items():
        img32, pts, wts, og32 = op_inputs(**case, out_grad=True)
        for dtype in TOL:
            img, og = img32.to(dtype), og32.to(dtype)
            for padding_mode, align_corners in MODES:
                got = cuda_bwd.msda_bwd(img, case["shapes"], pts, wts, og,
                                        padding_mode, align_corners)
                torch.cuda.synchronize()
                want = plain_msda_bwd(img, case["shapes"], pts, wts, og,
                                      padding_mode, align_corners)
                report, ok = [], True
                for grad, g, w, tol in zip(
                        ("img", "points", "weights"), got, want,
                        (IMG_GRAD_TOL[dtype], POINT_GRAD_TOL,
                         POINT_GRAD_TOL)):
                    if g.shape != w.shape or g.dtype != w.dtype:
                        raise AssertionError(
                            f"{name}: K2 gave {grad}_grad {g.shape} "
                            f"{g.dtype}, plain {w.shape} {w.dtype}")
                    abs_err, _, mixed = errors(g, w)
                    ok &= mixed <= tol and torch.isfinite(g).all().item()
                    report.append(f"{grad} {abs_err:.2e}/{mixed:.2e} "
                                  f"(tol {tol:g})")
                    if name == "encoder" and dtype == torch.float32:
                        enc_f32_err = max(enc_f32_err, abs_err)
                log(f"K2 {name:18s} {str(dtype)[6:]:8s} {padding_mode:6s} "
                    f"ac={int(align_corners)}: max_abs/err "
                    f"{'; '.join(report)} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"K2 disagrees with the plain version: {name} "
                        f"{dtype} {padding_mode} ac={align_corners}")
                del got, want
        del img32, pts, wts, og32
    return enc_f32_err


def make_pyramid(seed: int, shapes=SLICE_SHAPES, batch: int = BATCH):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (batch, h, w, c), dtype=np.float32)).to(DEVICE)
        for (h, w), c in zip(shapes, IN_CHANNELS)]


def model_shapes(hw) -> tuple:
    """The pyramid of an input of ``hw`` pixels: ``ceil(size / stride)``
    at strides 8/16/32/64."""
    return tuple((-(-hw[0] // s), -(-hw[1] // s)) for s in STRIDES)


class _Captured(Exception):
    pass


def model_call(hw=IMAGE_HW, batch: int = BATCH, call: int = 0,
               seed: int = 30):
    """The op's arguments at its ``call``-th call in one forward of the
    full-width two-stage model (0: encoder layer 0, 6: decoder layer 0) on
    a seeded pyramid for an input of ``hw`` pixels: the sampling pattern of
    the main path.  Spied at the op (``models.attention`` calls
    ``multiscale_deformable_attention``), so that the router's choice does
    not matter; the forward stops at that call.  Returns ``(img, shapes,
    pts, wts)``, f32 and contiguous."""
    shapes = model_shapes(hw)
    model = build_model("cuda", True)
    pyramid = make_pyramid(seed, shapes, batch)
    seen, real = [], attention.multiscale_deformable_attention

    def spy(img, img_shapes, pts, wts, *args, **kwargs):
        if len(seen) == call:
            seen.append((img, pts, wts))
            raise _Captured
        seen.append(None)
        return real(img, img_shapes, pts, wts, *args, **kwargs)

    attention.multiscale_deformable_attention = spy
    try:
        with torch.inference_mode():
            model(pyramid, shapes)
    except _Captured:
        pass
    finally:
        attention.multiscale_deformable_attention = real
    img, pts, wts = (t.float().contiguous().clone() for t in seen[call])
    del model, pyramid, seen
    return img, shapes, pts, wts


def make_targets(seed: int):
    """Synthetic targets for the batch: TARGET_SLOTS slots per image, a
    seeded 5 to 9 of them real; labels in [0, 91), cxcywh boxes with w and
    h in [0.05, 0.5] inside the image."""
    rng = np.random.default_rng(seed)
    shape = (BATCH, TARGET_SLOTS)
    wh = rng.uniform(0.05, 0.5, shape + (2,))
    centers = wh / 2 + rng.random(shape + (2,)) * (1 - wh)
    mask = np.zeros(shape, np.float32)
    for b in range(BATCH):
        mask[b, :rng.integers(5, 10)] = 1.0
    return {
        "labels": torch.from_numpy(rng.integers(
            0, MODEL["num_classes"], shape)).to(DEVICE),
        "boxes": torch.from_numpy(np.concatenate(
            [centers, wh], -1).astype(np.float32)).to(DEVICE),
        "mask": torch.from_numpy(mask).to(DEVICE),
    }


def build_model(impl: str, two_stage: bool, compute_dtype=None,
                remat=False, mesh=None):
    model = DeformableDetr(**MODEL, two_stage=two_stage, impl=impl,
                           compute_dtype=compute_dtype, remat=remat,
                           device=DEVICE, mesh=mesh)
    return init_parameters(model, torch.Generator().manual_seed(0)).eval()


def check_model_parity() -> None:
    pyramid = make_pyramid(10)
    outs = {}
    for impl in ("cuda", "reference"):
        model = build_model(impl, two_stage=False)
        with torch.inference_mode():
            outs[impl] = model(pyramid, SLICE_SHAPES)
        torch.cuda.synchronize()
        del model
    for key in ("logits", "boxes"):
        got, want = outs["cuda"][key], outs["reference"][key]
        abs_err, _, mixed = errors(got, want)
        ok = mixed <= MODEL_TOL and torch.isfinite(got).all().item()
        log(f"model parity {key:6s} {tuple(got.shape)}: max_abs {abs_err:.3e}"
            f" err {mixed:.3e} (tol {MODEL_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full-width model: impl='cuda' and "
                                 f"impl='reference' disagree on {key}")


def check_gradient_parity() -> None:
    """Phase 3, gradients: the loss and every parameter's gradient, cuda
    against reference (the reference with remat=True, so that one encoder
    layer's gathers are alive at a time; the gradients are the same)."""
    pyramid, targets = make_pyramid(11), make_targets(12)
    grads, losses = {}, {}
    for impl in ("cuda", "reference"):
        model = build_model(impl, two_stage=False,
                            remat=impl == "reference").train()
        before = cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES
        loss = detection_loss(model(pyramid, SLICE_SHAPES), targets,
                              matcher="fixed", class_loss="focal")
        loss.backward()
        torch.cuda.synchronize()
        launched = (cuda_fwd.LAUNCHES - before[0],
                    cuda_bwd.LAUNCHES - before[1])
        want = (12, 12) if impl == "cuda" else (0, 0)
        if launched != want:
            raise AssertionError(f"impl={impl!r} launched (K1, K2) "
                                 f"{launched}, expected {want}")
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
    floor = GRAD_FLOOR * max(g.abs().max().item()
                             for g in grads["reference"].values())
    worst, worst_name = 0.0, ""
    for name, want in grads["reference"].items():
        got = grads["cuda"][name]
        if got is None or not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is missing or not "
                                 "finite with impl='cuda'")
        scale = max(want.abs().max().item(), floor)
        err = (got - want).abs().max().item() / scale
        if err > worst:
            worst, worst_name = err, name
    loss_err = abs(losses["cuda"] - losses["reference"]) / abs(
        losses["reference"])
    ok = worst <= GRAD_TOL and loss_err <= MODEL_TOL
    log(f"gradient parity: loss cuda {losses['cuda']:.6f} reference "
        f"{losses['reference']:.6f} (rel {loss_err:.2e}, tol {MODEL_TOL:g});"
        f" {len(grads['cuda'])} parameter gradients, worst {worst:.2e} "
        f"({worst_name}) of each tensor's largest gradient (tol "
        f"{GRAD_TOL:g}, floor {GRAD_FLOOR:g} of the model's largest, "
        f"{floor:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-width gradients: impl='cuda' and "
                             "impl='reference' disagree")


def serve_once(model, pyramid, image_sizes):
    before = cuda_fwd.LAUNCHES
    out = model(pyramid, SLICE_SHAPES)
    det = postprocess(out, top_k=100, scoring="sigmoid",
                      image_sizes=image_sizes)
    launched = cuda_fwd.LAUNCHES - before
    if launched != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"a forward launched the kernel {launched} "
                             f"times, expected {LAUNCHES_PER_FORWARD}")
    return out, det


def check_outputs(out, det) -> None:
    expect = {
        "logits": (BATCH, MODEL["num_queries"], MODEL["num_classes"]),
        "boxes": (BATCH, MODEL["num_queries"], 4),
    }
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            raise AssertionError(f"model output {k}: {tuple(out[k].shape)}, "
                                 f"expected finite {shape}")
    check_detections(det)


def check_detections(det) -> None:
    for k, shape in (("scores", (BATCH, 100)), ("labels", (BATCH, 100)),
                     ("boxes", (BATCH, 100, 4))):
        if tuple(det[k].shape) != shape:
            raise AssertionError(f"detections {k}: {tuple(det[k].shape)}")
    s = det["scores"]
    if not (torch.isfinite(det["boxes"]).all() and (s >= 0).all()
            and (s <= 1).all() and (s[:, :-1] >= s[:, 1:]).all()):
        raise AssertionError("detections are not finite, sorted scores")
    if not ((det["labels"] >= 0).all()
            and (det["labels"] < MODEL["num_classes"]).all()):
        raise AssertionError("labels out of range")


def serve(smi: str) -> tuple[dict, dict]:
    """Phase 4: the main path.  Returns every kernel's launch count and the
    mean request time in ms of each dtype."""
    image_sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
    requests = [make_pyramid(20 + i) for i in range(3)]
    models = {"f32": build_model("auto", True),
              "bf16": build_model("auto", True, torch.bfloat16)}
    torch.cuda.synchronize()

    reset_launches()
    forwards, means = 0, {}
    with torch.inference_mode():
        for name, model in models.items():
            serve_once(model, requests[0], image_sizes)  # warm-up
            forwards += 1
            torch.cuda.synchronize()
            times = []
            for pyramid in requests:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out, det = serve_once(model, pyramid, image_sizes)
                end.record()
                torch.cuda.synchronize()
                forwards += 1
                times.append(start.elapsed_time(end))
                check_outputs(out, det)
            means[name] = sum(times) / len(times)
            log(f"serving {name}: batch {BATCH} at {IMAGE_HW[0]}x"
                f"{IMAGE_HW[1]}, per-request ms "
                f"{', '.join(f'{t:.3f}' for t in times)} "
                f"(mean {sum(times) / len(times):.3f}) on {smi}")
    counts = launches()
    if forwards == 0:
        raise AssertionError("no forward was served")
    # Deformable DETR's pyramid stays on K1 (stream.use_streaming_fwd)
    check_path_launches("serving", counts, {
        cuda_fwd.KERNEL: forwards * LAUNCHES_PER_FORWARD})
    log(f"serving: {forwards} forwards, launches {counts} "
        f"({LAUNCHES_PER_FORWARD} K1 per forward)")
    return counts, means


def train(smi: str) -> tuple[dict, dict, dict]:
    """Phase 5: the main path of the backward.  Returns every kernel's
    launches over the training run and in one f32 step (no remat), and the
    mean step time in ms of each run."""
    pyramid, targets = make_pyramid(30), make_targets(31)
    reset_launches()
    steps, per_step, means = 0, {}, {}
    expected = {cuda_fwd.KERNEL: 0, cuda_bwd.KERNEL: 0}
    runs = (("f32", None, False, 1 + TRAIN_STEPS),
            ("bf16", torch.bfloat16, False, 1 + TRAIN_STEPS),
            ("f32 remat", None, True, 1))
    for name, compute_dtype, remat, n_steps in runs:
        model = build_model("auto", True, compute_dtype, remat).train()
        optimizer = torch.optim.AdamW(model.parameters(), lr=2e-4,
                                      weight_decay=1e-4)
        step = make_train_step(model, optimizer, SLICE_SHAPES,
                               return_metrics=True, **LOSS_KW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_per_step = 2 * LAUNCHES_PER_FORWARD if remat else (
            LAUNCHES_PER_FORWARD)
        losses, times = [], []
        for i in range(n_steps):
            before = launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss, metrics = step(pyramid, targets)
            end.record()
            torch.cuda.synchronize()
            steps += 1
            counts = launches()
            counts = {k: counts[k] - before[k] for k in counts}
            launched = counts[cuda_fwd.KERNEL], counts[cuda_bwd.KERNEL]
            if name == "f32":
                per_step = counts
            losses.append(loss.item())
            times.append(start.elapsed_time(end))
            expected[cuda_fwd.KERNEL] += k1_per_step
            expected[cuda_bwd.KERNEL] += LAUNCHES_PER_FORWARD
            log(f"train {name} step {i} ({'warm-up' if i == 0 else 'timed'})"
                f": loss {losses[-1]:.6f} matcher_converged "
                f"{bool(metrics['matcher_converged'])} {times[-1]:.3f} ms, "
                f"K1 {launched[0]} K2 {launched[1]} launches")
            if launched != (k1_per_step, LAUNCHES_PER_FORWARD):
                raise AssertionError(
                    f"a {name} training step launched (K1, K2) {launched}, "
                    f"expected {(k1_per_step, LAUNCHES_PER_FORWARD)}")
            if not np.isfinite(losses[-1]):
                raise AssertionError(f"{name}: loss is not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        timed = times[1:] or times
        means[name] = sum(timed) / len(timed)
        log(f"train {name}: batch {BATCH} at {IMAGE_HW[0]}x{IMAGE_HW[1]}, "
            f"mean step {sum(timed) / len(timed):.3f} ms over {len(timed)} "
            f"step(s), peak allocated {peak:.3f} GiB on {smi}")
        if n_steps > 1 and not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall on a "
                                 f"repeated batch: {losses}")
        for p in model.parameters():
            if not torch.isfinite(p).all():
                raise AssertionError(f"{name}: a parameter is not finite")
        del model, optimizer, step
    counts = launches()
    # the pyramid stays on K1/K2 in f32 and bf16 (the L2 routers)
    check_path_launches("training", counts, expected)
    log(f"training: {steps} steps, launches {counts}; per f32 step "
        f"{per_step}")
    return counts, per_step, means


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernel(smi: str) -> dict:
    """Kernel vs plain version, in turns (plain, kernel, kernel, plain)."""
    times = {}
    with torch.inference_mode():
        for name in ("encoder", "decoder", "reference_workload"):
            case = OP_CASES[name]
            img32, pts, wts = op_inputs(**case)
            for dtype in (torch.float32, torch.bfloat16):
                img = img32.to(dtype)
                args = (img, case["shapes"], pts, wts)

                def kernel():
                    cuda_fwd.msda_fwd(*args)

                def plain():
                    plain_msda(*args)

                p1 = time_ms(plain, 5)
                k1 = time_ms(kernel, 50)
                k2 = time_ms(kernel, 50)
                p2 = time_ms(plain, 5)
                k, p = (k1 + k2) / 2, (p1 + p2) / 2
                b = bound(case["shapes"], img, pts, wts, False)
                times[(name, dtype)] = (k, p, b)
                log(f"time {name:18s} {str(dtype)[6:]:8s}: kernel {k:.4f} ms"
                    f" ({k1:.4f}, {k2:.4f}), plain {p:.4f} ms ({p1:.4f}, "
                    f"{p2:.4f}), plain/kernel {p / k:.2f}x; bound "
                    f"{b['ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
                    f"{b['flops']} FLOP), {100 * b['ms'] / k:.1f}% of it on "
                    f"{smi}")
            del img32, pts, wts
    return times


def time_backward_kernel(smi: str) -> dict:
    """K2 vs its plain version, in turns (plain, kernel, kernel, plain);
    then, once, autograd through the plain forward in the working dtype,
    which is what impl="reference" costs in training (the plain version
    sums in f64)."""
    times = {}
    for name in ("encoder", "decoder", "reference_workload"):
        case = OP_CASES[name]
        img32, pts, wts, og32 = op_inputs(**case, out_grad=True)
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            args = (img, case["shapes"], pts, wts, og)

            def kernel():
                cuda_bwd.msda_bwd(*args)

            def plain():
                plain_msda_bwd(*args)

            def autograd():
                with torch.enable_grad():
                    ins = [t.detach().requires_grad_(True)
                           for t in (img, pts, wts)]
                    out = plain_msda(ins[0], case["shapes"], *ins[1:])
                    torch.autograd.grad(out, ins, og)

            p1 = time_ms(plain, 3)
            k1 = time_ms(kernel, 20)
            k2 = time_ms(kernel, 20)
            p2 = time_ms(plain, 3)
            a = time_ms(autograd, 3)
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            b = bound(case["shapes"], img, pts, wts, True)
            times[(name, dtype)] = (k, p, b)
            log(f"time K2 {name:18s} {str(dtype)[6:]:8s}: kernel {k:.4f} ms"
                f" ({k1:.4f}, {k2:.4f}), plain {p:.4f} ms ({p1:.4f}, "
                f"{p2:.4f}), plain/kernel {p / k:.2f}x; autograd through "
                f"the plain forward {a:.4f} ms; bound {b['ms']:.4f} ms "
                f"({b['bound_by']}: {b['bytes']} B, {b['flops']} FLOP), "
                f"{100 * b['ms'] / k:.1f}% of it on {smi}")
            del args, img, og
        del img32, pts, wts, og32
    return times


def time_big_pyramid(smi: str) -> None:
    """K1 and K2 alone at the 256-base pyramid (f32 img of 356 MB, beyond
    the 50 MB L2): the measurement to take before a streamed large-pyramid
    kernel is designed."""
    img, pts, wts, og = op_inputs(BIG_SHAPES, B=4, N=10000, H=8, C=32, P=4,
                                  seed=40, out_grad=True)
    fwd = time_ms(lambda: cuda_fwd.msda_fwd(img, BIG_SHAPES, pts, wts), 20)
    bwd = time_ms(lambda: cuda_bwd.msda_bwd(img, BIG_SHAPES, pts, wts, og),
                  20)
    log(f"time big pyramid (256/128/64/32, I=87040, B=4, N=10000, H=8, C=32,"
        f" P=4, f32): K1 {fwd:.4f} ms, K2 {bwd:.4f} ms on {smi}")


# Phase 7.  Cases for the streamed kernels: the 256-base pyramid with the
# default plan; a small pyramid whose explicit plan cuts every level into
# several bands (and columns), widths not multiples of 8; the reference
# pyramid with a ragged N, out-of-bounds points and several bands; a skewed
# case with every point in one band of level 0 (a bin of all 40,000
# samples of each (b, h, level)); encoder layer 0's call of the full-width
# model at 1600x2666 (batch 1, the model's own points); and a coincident
# case with every point of a (b, h) at one place, so that each level's
# 40,000 samples of a (b, h) fall on one pixel (one bin, served in many
# slices and chunks, and the backward's runs of one pixel).
STREAM_CASES = {
    "big_pyramid": dict(shapes=BIG_SHAPES, B=4, N=10000, H=8, C=32, P=4,
                        seed=50, plan=None),
    "small_bands": dict(shapes=((30, 27), (15, 14), (8, 7), (4, 3)), B=2,
                        N=3037, H=8, C=32, P=4, seed=51,
                        plan=((4, 5), (3, 100), (2, 2), (1, 1))),
    "ragged_oob": dict(shapes=REF_SHAPES, B=2, N=1037, H=8, C=32, P=4,
                       seed=52, oob=True,
                       plan=((4, 64), (4, 9), (3, 16), (8, 8))),
    "skewed": dict(shapes=REF_SHAPES, B=1, N=10000, H=8, C=32, P=4, seed=53,
                   skew=True, plan=((4, 64), (8, 32), (8, 16), (8, 8))),
    "model_1600x2666": dict(shapes=model_shapes(MODEL_SIZES[-1]), B=1, C=32,
                            seed=54, model=MODEL_SIZES[-1], plan=None),
    "coincident": dict(shapes=REF_SHAPES, B=2, N=10000, H=8, C=32, P=4,
                       seed=55, coincident=True, plan=None),
}
SWEEP_BASES = (64, 128, 256, 512)


def stream_inputs(shapes, B, C, seed, N=None, H=8, P=4, oob=False,
                  skew=False, coincident=False, model=None, plan=None):
    """``op_inputs`` (with out_grad); ``skew`` puts every point's y in
    [0.40, 0.41), one band of each level; ``coincident`` puts every point
    of a (b, h) where its first one is (with a non-negative out_grad);
    ``model`` takes img, points and
    weights from ``model_call`` at that input size (out_grad seeded)."""
    if model is not None:
        img, _, pts, wts = model_call(model, B)
        rng = np.random.default_rng(seed)
        og = torch.from_numpy(rng.standard_normal(
            (B, pts.shape[1], H, C), dtype=np.float32)).to(DEVICE)
        return img, pts, wts, og
    img, pts, wts, og = op_inputs(shapes, B, N, H, C, P, seed, oob=oob,
                                  out_grad=True)
    if skew:
        pts[..., 1] = 0.40 + 0.01 * pts[..., 1]
    if coincident:
        pts = pts[:, :1, :, :1, :1].expand_as(pts).contiguous()
        # a pixel then sums 40,000 img_grad terms: with signs at random,
        # any two f32 orders of that sum differ by about 1e-4 of it, the
        # plain version's too, so out_grad is taken non-negative
        og = og.abs()
    return img, pts, wts, og


def check_bins(name, case, pts, wts) -> float:
    """The binning kernels against ``stream.sample_bins``: the same count in
    every bin, the records' indices a permutation of the samples, bin by
    bin, each with its sample's point and weight.  Returns the largest
    difference of a bin's count."""
    shapes = case["shapes"]
    plan = stream.check_plan(shapes, case["plan"], case["C"], torch.float32)
    records, _, counts, _ = cuda_stream.bin_samples(pts, wts, shapes, plan)
    torch.cuda.synchronize()
    order = records.view(torch.int32)[:, 3]
    bins = stream.sample_bins(pts, shapes, plan).flatten()
    want = torch.bincount(bins, minlength=counts.numel())
    ok = (torch.equal(counts.long(), want)
          and torch.equal(torch.sort(order.long()).values,
                          torch.arange(order.numel(), device=DEVICE))
          and torch.equal(bins[order.long()], torch.repeat_interleave(
              torch.arange(counts.numel(), device=DEVICE), want))
          and torch.equal(records[:, :2], pts.reshape(-1, 2)[order.long()])
          and torch.equal(records[:, 2], wts.flatten()[order.long()]))
    log(f"bins {name:12s}: {counts.numel()} bins, largest "
        f"{int(want.max())} samples, {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the binning disagrees with sample_bins: {name}")
    return float((counts.long() - want).abs().max())


def check_stream_kernels() -> dict:
    """Phase 7a; returns the largest f32 abs error of K3', K4' + K5' and
    the binning at the 256-base pyramid."""
    errs = dict.fromkeys(("msda_stream_fwd", "msda_stream_bwd",
                          "msda_stream_bin"), 0.0)
    for name, case in STREAM_CASES.items():
        img32, pts, wts, og32 = stream_inputs(**case)
        shapes, plan = case["shapes"], case["plan"]
        bin_err = check_bins(name, case, pts, wts)
        if name == "big_pyramid":
            errs["msda_stream_bin"] = bin_err
        for dtype in TOL:
            img, og = img32.to(dtype), og32.to(dtype)
            for padding_mode, align_corners in MODES:
                mode = (padding_mode, align_corners)
                got = cuda_stream.msda_stream_fwd(img, shapes, pts, wts, *mode,
                                                  plan=plan)
                torch.cuda.synchronize()
                want = stream.plain_stream_fwd(img, shapes, pts, wts, *mode,
                                               plan=plan)
                report, ok = [], True
                pairs = [("out", got, want, TOL[dtype])]
                del got, want
                grads = cuda_stream.msda_stream_bwd(img, shapes, pts, wts, og,
                                                    *mode, plan=plan)
                torch.cuda.synchronize()
                wants = stream.plain_stream_bwd(img, shapes, pts, wts, og,
                                                *mode, plan=plan)
                pairs += list(zip(("img", "points", "weights"), grads, wants,
                                  (IMG_GRAD_TOL[dtype], POINT_GRAD_TOL,
                                   POINT_GRAD_TOL)))
                for what, g, w, tol in pairs:
                    if g.shape != w.shape or g.dtype != w.dtype:
                        raise AssertionError(
                            f"{name}: streamed {what} {g.shape} {g.dtype}, "
                            f"plain {w.shape} {w.dtype}")
                    abs_err, _, mixed = errors(g, w)
                    ok &= mixed <= tol and torch.isfinite(g).all().item()
                    report.append(f"{what} {abs_err:.2e}/{mixed:.2e}")
                    if name == "big_pyramid" and dtype == torch.float32:
                        key = ("msda_stream_fwd" if what == "out"
                               else "msda_stream_bwd")
                        errs[key] = max(errs[key], abs_err)
                log(f"stream {name:12s} {str(dtype)[6:]:8s} {padding_mode:6s}"
                    f" ac={int(align_corners)}: max_abs/err "
                    f"{'; '.join(report)} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"a streamed kernel disagrees with its plain version:"
                        f" {name} {dtype} {padding_mode} ac={align_corners}")
                del pairs, grads, wants
        del img32, pts, wts, og32
    return errs


def run_path(name: str, shapes, B: int, seed: int, expected: dict,
             smi: str) -> dict:
    """The op through impl="auto", forward and backward, 1 + 3 times at
    ``shapes`` (N=10,000, f32), against the plain streamed versions;
    ``expected``: each kernel's launches per step.  Returns every kernel's
    launch count over the run."""
    img, shapes, pts, wts, og = reference_workload(
        10000, torch.float32, shapes, seed=seed, batch=B, device=DEVICE)
    _, _, H, C = img.shape
    l2 = stream.l2_bytes(DEVICE)
    routes = (stream.use_streaming_fwd(shapes, H, C, img.dtype, l2),
              stream.use_streaming_bwd(shapes, H, C, img.dtype, l2))
    size = img[0].numel() * img.element_size()
    log(f"{name}: one image's pyramid {size} bytes, L2 {l2} bytes; streams "
        f"(fwd, bwd) {routes}")
    steps = 4
    times = []
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(steps):
        leaves = [t.detach().requires_grad_(True) for t in (img, pts, wts)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = msda(leaves[0], shapes, *leaves[1:], benchmark.PADDING,
                   benchmark.ALIGN, impl="auto")
        grads = torch.autograd.grad(out, leaves, og)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    counts = launches()
    check_path_launches(name, counts, {k: steps * n
                                       for k, n in expected.items()})
    mode = (benchmark.PADDING, benchmark.ALIGN)
    pairs = [("out", out.detach(), stream.plain_stream_fwd(
        img, shapes, pts, wts, *mode), TOL[torch.float32])]
    pairs += list(zip(("img", "points", "weights"), grads,
                      stream.plain_stream_bwd(img, shapes, pts, wts, og,
                                              *mode),
                      (IMG_GRAD_TOL[torch.float32], POINT_GRAD_TOL,
                       POINT_GRAD_TOL)))
    report, ok = [], True
    for what, g, w, tol in pairs:
        abs_err, _, mixed = errors(g, w)
        ok &= (g.shape == w.shape and mixed <= tol
               and torch.isfinite(g).all().item())
        report.append(f"{what} {abs_err:.2e}/{mixed:.2e}")
    log(f"{name} (B={B}, N=10000, f32, {mode[0]}, ac={int(mode[1])}): "
        f"fwd+bwd ms {', '.join(f'{t:.3f}' for t in times)} (first is the "
        f"warm-up); launches {counts}; vs plain max_abs/err "
        f"{'; '.join(report)} {'ok' if ok else 'FAIL'} on {smi}")
    if not ok:
        raise AssertionError(f"{name} disagrees with the plain versions")
    return counts


def large_pyramid_path(smi: str) -> dict:
    """Phase 7b: the refitted routes.  At the 512-base pyramid (B=2) the
    router keeps the forward on K1 and the backward on K2; with
    ``stream.forced()``, at the 256-base pyramid (B=4), both go to the
    streamed kernels.  Returns {path: every kernel's launch count}."""
    auto = run_path("large-pyramid path", PATH_SHAPES, 2, 60, {
        cuda_fwd.KERNEL: 1, cuda_bwd.KERNEL: 1}, smi)
    with stream.forced():
        forced = run_path("forced streamed path", BIG_SHAPES, 4, 62, {
            "msda_stream_fwd": 1, "msda_stream_bwd": 1,
            "msda_stream_bin": 2}, smi)
    return {"large_pyramid": auto, "forced_stream": forced}


def time_stream_kernels(smi: str) -> dict:
    """Phase 7c: at the 256-base pyramid, in turns, the plain versions, the
    streamed kernels and K1/K2.  Returns {(kernel, dtype): (ms, plain ms,
    msda_bound's dict)}; K1/K2's times are logged beside them."""
    times = {}
    img32, pts, wts, og32 = stream_inputs(BIG_SHAPES, B=4, N=10000, H=8,
                                          C=32, P=4, seed=61)
    rows = touched_rows(BIG_SHAPES, pts, wts)
    for dtype in (torch.float32, torch.bfloat16):
        img, og = img32.to(dtype), og32.to(dtype)
        plan = stream.pyramid_plan(BIG_SHAPES, 32, dtype)
        fwd = (lambda: stream.plain_stream_fwd(img, BIG_SHAPES, pts, wts),
               lambda: cuda_stream.msda_stream_fwd(img, BIG_SHAPES, pts, wts),
               lambda: cuda_fwd.msda_fwd(img, BIG_SHAPES, pts, wts))
        bwd = (lambda: stream.plain_stream_bwd(img, BIG_SHAPES, pts, wts, og),
               lambda: cuda_stream.msda_stream_bwd(img, BIG_SHAPES, pts, wts,
                                                   og),
               lambda: cuda_bwd.msda_bwd(img, BIG_SHAPES, pts, wts, og))
        pts32 = pts.contiguous()
        binning = (lambda: torch.sort(stream.sample_bins(pts32, BIG_SHAPES,
                                                         plan).flatten()),
                   lambda: cuda_stream.bin_samples(pts32, wts, BIG_SHAPES,
                                                   plan),
                   None)
        # what a binning must move: the points in, one int32 place per
        # sample and an int32 count and start per bin out (the records the
        # kernels' binning writes are an intermediate of their design)
        B, N, H, L, P, _ = pts.shape
        C = img.shape[-1]
        bins = B * H * stream.num_bins(BIG_SHAPES, plan)
        bin_bytes = pts32.numel() * 4 + wts.numel() * 4 + bins * 8
        bin_ms, bin_by = roofline_ms(bin_bytes, 0)
        bounds = {
            "msda_stream_fwd": msda_bound(BIG_SHAPES, B, N, H, C, P, dtype,
                                          False, rows),
            "msda_stream_bwd": msda_bound(BIG_SHAPES, B, N, H, C, P, dtype,
                                          True, rows),
            "msda_stream_bin": {"ms": bin_ms, "bound_by": bin_by,
                                "bytes": bin_bytes, "flops": 0}}
        for name, (plain, kernel, resident) in (
                ("msda_stream_fwd", fwd), ("msda_stream_bwd", bwd),
                ("msda_stream_bin", binning)):
            p1 = time_ms(plain, 3)
            k1 = time_ms(kernel, 20)
            r1 = time_ms(resident, 20) if resident else float("nan")
            r2 = time_ms(resident, 20) if resident else float("nan")
            k2 = time_ms(kernel, 20)
            p2 = time_ms(plain, 3)
            k, p, r = (k1 + k2) / 2, (p1 + p2) / 2, (r1 + r2) / 2
            b = bounds[name]
            times[(name, dtype)] = (k, p, b)
            vs = (f", {'K1' if name.endswith('fwd') else 'K2'} {r:.4f} ms "
                  f"({r1:.4f}, {r2:.4f}), resident/streamed {r / k:.2f}x"
                  if resident else "")
            log(f"time {name:16s} big pyramid {str(dtype)[6:]:8s}: kernel "
                f"{k:.4f} ms ({k1:.4f}, {k2:.4f}), plain {p:.4f} ms "
                f"({p1:.4f}, {p2:.4f}), plain/kernel {p / k:.2f}x{vs}; "
                f"bound {b['ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B), "
                f"{100 * b['ms'] / k:.1f}% of it on {smi}")
    return times


def sweep_cases():
    """Phase 7d's points: (name, pyramid, f32 inputs) for the uniform
    bases (B=4, N=10,000) and encoder layer 0's call of the full-width
    model at each of MODEL_SIZES (batch 2) and LARGE_MODEL_SIZES (batch 1),
    the model's own points."""
    for base in SWEEP_BASES:
        shapes = tuple((base >> i, base >> i) for i in range(4))
        img, _, pts, wts, og = reference_workload(
            10000, torch.float32, shapes, seed=70, device=DEVICE)
        yield f"base {base}", shapes, (img, pts, wts, og)
    for sizes, batch in ((MODEL_SIZES, BATCH), (LARGE_MODEL_SIZES, 1)):
        for hw in sizes:
            inputs = stream_inputs(model_shapes(hw), B=batch, C=32, seed=71,
                                   model=hw)
            yield f"model {hw[0]}x{hw[1]}", model_shapes(hw), inputs


def sweep_pyramids(smi: str) -> list:
    """Phase 7d: streamed against resident calls (the wrappers, binning
    and buffers included), in turns (resident, streamed, streamed,
    resident), and the router's choice beside both times.  Returns rows
    (point, dtype, direction, resident ms, streamed ms, streams)."""
    rows = []
    l2 = stream.l2_bytes(DEVICE)
    for name, shapes, (img32, pts, wts, og32) in sweep_cases():
        H, C = img32.shape[2], img32.shape[3]
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            line = []
            for direction, resident, streamed, route in (
                    ("fwd", lambda: cuda_fwd.msda_fwd(img, shapes, pts, wts),
                     lambda: cuda_stream.msda_stream_fwd(img, shapes, pts,
                                                         wts),
                     stream.use_streaming_fwd),
                    ("bwd", lambda: cuda_bwd.msda_bwd(img, shapes, pts, wts,
                                                      og),
                     lambda: cuda_stream.msda_stream_bwd(img, shapes, pts,
                                                         wts, og),
                     stream.use_streaming_bwd)):
                r1 = time_ms(resident, 5)
                s1 = time_ms(streamed, 5)
                s2 = time_ms(streamed, 5)
                r2 = time_ms(resident, 5)
                r, t = (r1 + r2) / 2, (s1 + s2) / 2
                streams = route(shapes, H, C, dtype, l2)
                picked, best = (t if streams else r), min(r, t)
                rows.append((name, dtype, direction, r, t, streams))
                line.append(
                    f"{direction} {'K1' if direction == 'fwd' else 'K2'} "
                    f"{r:.4f} / streamed {t:.4f} ms, router "
                    f"{'streams' if streams else 'resident'} "
                    f"({100 * (picked / best - 1):+.1f}% of the faster)")
            log(f"sweep {name:16s} (I={img.shape[1]}, B={img.shape[0]}, img "
                f"{img.numel() * img.element_size() / 1e6:.1f} MB) "
                f"{str(dtype)[6:]:8s}: {'; '.join(line)} on {smi}")
            del img, og
        del img32, pts, wts, og32
    return rows


def benchmark_row(smi: str) -> None:
    """Phase 7e: the benchmark entry point at the 256-base pyramid."""
    rows = benchmark.main(["--pyramid", "big", "--queries", "10000",
                           "--impls", "cuda", "reference", "--bf16",
                           "--out", os.path.join(os.path.dirname(
                               os.path.abspath(__file__)), "build",
                               "benchmark_big_smoke.csv")])
    for row in rows:
        if not all(np.isfinite(row[k]) and row[k] > 0
                   for k in ("fwd_ms", "fwdbwd_ms", "peak_mem_mb")):
            raise AssertionError(f"benchmark row not finite: {row}")
    log(f"benchmark --pyramid big: {len(rows)} rows on {smi}")


# Phase 8: the operators, the exported artifact, profiles, entry points.
ROOT = os.path.dirname(os.path.abspath(__file__))
EXPORT_DIR = os.path.join(ROOT, "build", "export_smoke")
TRACE_DIR = os.path.join(ROOT, "build", "traces")
REQUEST_SEEDS = (20, 21, 22)  # phase 4's requests
# exported against live detections: labels equal, scores and boxes within
# tol * max(1, |live|) (both run the same operators in the same order)
EXPORT_TOL = {"f32": 1e-5, "bf16": 1e-2}
# the exported bf16 model's mean request in the serving process, at most
# this many times phase 4's live bf16 mean (the card's host noise alone
# moved serving by up to 1.4x between calls)
EXPORT_SLOWDOWN_MAX = 2.0
SPANS = ("encoder", "decoder", "postprocess", "loss", "backward",
         "optimizer")

# The serving process of phase 8b: it imports torch, numpy and
# msda_tpu_torch.utils.export only, loads each artifact, serves a warm-up
# and the requests of REQUEST_SEEDS (built as make_pyramid builds them),
# counts the kernels' launches a forward (from the wrappers' modules that
# the operator loaded), times each request with CUDA events, saves the
# detections and prints a JSON line.
_SERVE_EXPORTED = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from msda_tpu_torch.utils.export import load_exported_file

spec = json.loads(sys.argv[2])


def counts():
    mods = {n: sys.modules.get("msda_tpu_torch.ops." + n)
            for n in ("cuda_fwd", "cuda_bwd", "cuda_stream")}
    out = {"msda_fwd": getattr(mods["cuda_fwd"], "LAUNCHES", 0),
           "msda_bwd": getattr(mods["cuda_bwd"], "LAUNCHES", 0)}
    out.update(getattr(mods["cuda_stream"], "LAUNCHES", {}))
    return out


def pyramid(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (spec["batch"], h, w, c), dtype=np.float32)).cuda()
        for (h, w), c in zip(spec["shapes"], spec["channels"])]


result = {}
for name in spec["models"]:
    serve = load_exported_file(f"{spec['dir']}/{name}.pt2")
    requests = [pyramid(seed) for seed in spec["seeds"]]
    per_forward, times = [], []
    with torch.inference_mode():
        serve(*requests[0])  # warm-up: builds the kernels
        torch.cuda.synchronize()
        for i, pyr in enumerate(requests):
            before = counts()["msda_fwd"]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            det = serve(*pyr)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            per_forward.append(counts()["msda_fwd"] - before)
            torch.save({k: v.cpu() for k, v in det.items()},
                       f"{spec['dir']}/{name}_{i}.pt")
    result[name] = {"k1_per_forward": per_forward, "ms": times,
                    "forwards": 1 + len(requests)}
result["launches"] = counts()
result["free_bytes"] = torch.cuda.mem_get_info()[0]
print(json.dumps(result))
"""


def opcheck_on_card() -> None:
    """Phase 8a: ``torch.library.opcheck`` of both operators on CUDA
    tensors at the decoder's shapes, f32 and bf16, both paddings."""
    case = OP_CASES["decoder"]
    img32, pts, wts, og32 = op_inputs(**case, out_grad=True)
    flat = library.flat_shapes(case["shapes"])
    for dtype in (torch.float32, torch.bfloat16):
        img, og = img32.to(dtype), og32.to(dtype)
        for padding_mode in ("border", "zeros"):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (img, pts, wts)]
            torch.library.opcheck(library.msda_fwd,
                                  (*leaves, flat, padding_mode, False))
            torch.library.opcheck(library.msda_bwd,
                                  (img, pts, wts, og, flat, padding_mode,
                                   False))
            log(f"opcheck msda_fwd, msda_bwd {str(dtype)[6:]:8s} "
                f"{padding_mode}: ok")


def export_path(smi: str, live_ms: dict) -> dict:
    """Phase 8b: export the full-width two-stage model's forward +
    postprocess in f32 and bf16, serve the artifacts in a process that
    never built the model, and hold its detections against the live
    model's.  Returns every kernel's launch count in that process."""
    image_sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
    os.makedirs(EXPORT_DIR, exist_ok=True)
    live = {}
    for name, compute_dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = build_model("auto", True, compute_dtype)

        def serve_fn(*pyr):
            return postprocess(model(list(pyr), SLICE_SHAPES), top_k=100,
                               scoring="sigmoid", image_sizes=image_sizes)

        t0 = time.perf_counter()
        blob = export_fn(serve_fn, *make_pyramid(REQUEST_SEEDS[0]))
        seconds = time.perf_counter() - t0
        path = os.path.join(EXPORT_DIR, f"{name}.pt2")
        save_exported(blob, path)
        log(f"export {name}: {seconds:.2f} s, {os.path.getsize(path)} bytes"
            f" -> {os.path.relpath(path, ROOT)}")
        with torch.inference_mode():
            live[name] = [serve_fn(*make_pyramid(s)) for s in REQUEST_SEEDS]
        del model, blob
    # give the serving process the card's memory: this process's allocator
    # still caches the blocks of phases 1-7, and a process short of memory
    # frees and retries on its allocations
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spec = {"dir": EXPORT_DIR, "models": list(live), "seeds": REQUEST_SEEDS,
            "batch": BATCH, "shapes": SLICE_SHAPES, "channels": IN_CHANNELS}
    run = subprocess.run([sys.executable, "-c", _SERVE_EXPORTED, ROOT,
                          json.dumps(spec)], capture_output=True, text=True,
                         timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"the serving process failed (exit "
                           f"{run.returncode}):\n{run.stderr[-4000:]}")
    served = json.loads(run.stdout.strip().splitlines()[-1])
    forwards = 0
    for name, dets in live.items():
        got = served[name]
        if got["k1_per_forward"] != [LAUNCHES_PER_FORWARD] * len(dets):
            raise AssertionError(f"exported {name}: K1 launches a forward "
                                 f"{got['k1_per_forward']}, expected "
                                 f"{LAUNCHES_PER_FORWARD}")
        forwards += got["forwards"]
        worst = 0.0
        for i, want in enumerate(dets):
            det = torch.load(os.path.join(EXPORT_DIR, f"{name}_{i}.pt"))
            check_detections(det)
            if not torch.equal(det["labels"], want["labels"].cpu()):
                raise AssertionError(f"exported {name}, request {i}: the "
                                     "labels differ from the live model's")
            for k in ("scores", "boxes"):
                worst = max(worst, errors(det[k], want[k].cpu())[2])
        ok = worst <= EXPORT_TOL[name]
        ms = got["ms"]
        log(f"exported {name}: {len(dets)} requests, labels equal, scores/"
            f"boxes err {worst:.3e} (tol {EXPORT_TOL[name]:g}) "
            f"{'ok' if ok else 'FAIL'}; K1 a forward {got['k1_per_forward']};"
            f" per-request ms {', '.join(f'{t:.3f}' for t in ms)} (mean "
            f"{sum(ms) / len(ms):.3f}; live, phase 4: {live_ms[name]:.3f}; "
            f"{served['free_bytes']} bytes free at the end) on {smi}")
        if not ok:
            raise AssertionError(f"exported {name}: detections differ from "
                                 "the live model's")
        ratio = sum(ms) / len(ms) / live_ms[name]
        log(f"exported {name}: serving process / live mean {ratio:.2f}x"
            + (f" (bar {EXPORT_SLOWDOWN_MAX:g}x)" if name == "bf16" else ""))
        if name == "bf16" and ratio > EXPORT_SLOWDOWN_MAX:
            raise AssertionError(f"exported bf16 serves {ratio:.2f}x slower "
                                 "than the live model")
    counts = served["launches"]
    if set(counts) != set(launches()):
        raise AssertionError(f"export: launch counts {counts}, expected the "
                             f"keys {sorted(launches())}")
    check_path_launches("export", counts, {
        cuda_fwd.KERNEL: forwards * LAUNCHES_PER_FORWARD})
    return counts


def report_trace(what: str, t, unprofiled_ms: float, smi: str) -> None:
    """Print a phase 8c capture: window, busy, idle (of the window, and of
    the same work's time without the profiler, from phase 4 or 5), the top
    10 kernels and the spans; fail if the profiler saw no device work."""
    kernels = t.kernel_ms()
    busy = t.busy_ms()
    if not kernels or not busy > 0:
        raise AssertionError(f"profile {what}: the trace holds no device "
                             "work")
    log(f"profile {what}: window {t.window_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle {100 * t.idle_share():.1f}% of the window, "
        f"{100 * (1 - busy / unprofiled_ms):.1f}% of the "
        f"{unprofiled_ms:.3f} ms it takes unprofiled on {smi} "
        f"({os.path.relpath(t.path, ROOT)})")
    for name, ms in list(kernels.items())[:10]:
        log(f"  {ms:9.3f} ms  {name[:110]}")
    host, device = t.span_ms(), t.span_ms(device=True)
    log("  spans (host / device ms): " + "; ".join(
        f"{name} {host[name]:.3f} / {device.get(name, float('nan')):.3f}"
        for name in SPANS if name in host))


def profile_paths(smi: str, serve_ms: dict, train_ms: dict) -> None:
    """Phase 8c: one f32 serving request and one f32 training step, each
    after its warm-up, under ``utils.profile.trace``; ``serve_ms`` and
    ``train_ms`` are phases 4 and 5's mean times."""
    image_sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
    pyramid = make_pyramid(REQUEST_SEEDS[0])
    model = build_model("auto", True)
    with torch.inference_mode():
        serve_once(model, pyramid, image_sizes)
        torch.cuda.synchronize()
        with trace(os.path.join(TRACE_DIR, "serve_f32")) as t:
            out = model(pyramid, SLICE_SHAPES)
            with annotate("postprocess"):
                postprocess(out, top_k=100, scoring="sigmoid",
                            image_sizes=image_sizes)
    report_trace("serving f32 request", t, serve_ms["f32"], smi)
    del model, out

    pyramid, targets = make_pyramid(30), make_targets(31)
    model = build_model("auto", True).train()
    optimizer = torch.optim.AdamW(model.parameters(), lr=2e-4,
                                  weight_decay=1e-4)
    step = make_train_step(model, optimizer, SLICE_SHAPES,
                           return_metrics=True, **LOSS_KW)
    step(pyramid, targets)
    torch.cuda.synchronize()
    with trace(os.path.join(TRACE_DIR, "train_f32")) as t:
        loss, _ = step(pyramid, targets)
    if not np.isfinite(loss.item()):
        raise AssertionError("profiled training step: loss not finite")
    report_trace("training f32 step", t, train_ms["f32"], smi)


def entry_points(smi: str) -> None:
    """Phase 8d: ``capture_trace --mode fwdbwd`` and ``memory_report``
    in-process at N=10,000; their numbers must be finite and positive."""
    got = capture_trace.main(["--mode", "fwdbwd", "--queries", "10000",
                              "--iters", "5", "--out",
                              os.path.join(TRACE_DIR, "smoke_fwdbwd")])
    numbers = [got["window_ms"], got["busy_ms"], *got["kernel_ms"].values()]
    if not got["kernel_ms"] or not all(np.isfinite(v) and v > 0
                                       for v in numbers):
        raise AssertionError(f"capture_trace: numbers not finite and "
                             f"positive: {got}")
    mem = memory_report.main(["--queries", "10000"])
    numbers = [mem["allocated_mb"], mem["trace_peak_mb"],
               *(size for size, _, _ in mem["residents"])]
    if not mem["residents"] or not all(np.isfinite(v) and v > 0
                                       for v in numbers):
        raise AssertionError(f"memory_report: numbers not finite and "
                             f"positive: {mem}")
    log(f"entry points: capture_trace busy {got['busy_ms']:.3f} ms of "
        f"{got['window_ms']:.3f}; memory_report {mem['allocated_mb']:.1f} MB "
        f"allocated, trace peak {mem['trace_peak_mb']:.1f} MB on {smi}")


# Phase 9: the device mesh, HF detection parity, the launch-constant sweep.
# One card: NCCL takes one rank a card, so the card runs a one-rank mesh
# (the split itself is held to JAX by tests/test_torch_sharding.py on CPU
# ranks).  The mesh step uses SGD: AdamW's first step divides each gradient
# by its own size, which would turn the rounding of near-zero gradients
# (K2's f32 atomics add in a run-dependent order) into full-size updates.
MESH_TOL = 1e-6
MESH_LR = 2e-4
HF_PATHS = {"deformable-detr": "hf_deformable_detr",
            "grounding-dino": "hf_grounding_dino"}


def dryrun_cpu(smi: str) -> None:
    """Phase 9a: ``python -m msda_tpu_torch.dryrun`` with 8 gloo ranks on
    the host's CPU."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "msda_tpu_torch.dryrun",
                          "--devices", "8", "--device", "cpu", "--timeout",
                          "300"], capture_output=True, text=True,
                         timeout=360, cwd=ROOT)
    line = (run.stdout.strip().splitlines() or [""])[-1]
    if run.returncode != 0 or not line.startswith(
            "dryrun_multichip(8): mesh dp=2 sp=2 tp=2, one train step OK"):
        raise RuntimeError(f"the dry run failed (exit {run.returncode}): "
                           f"{line}\n{run.stderr[-4000:]}")
    log(f"dry run, 8 gloo ranks on the host: {line} "
        f"({time.perf_counter() - t0:.1f} s; host of {smi})")


def _mesh_serve(model, pyramid, image_sizes):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    before = cuda_fwd.LAUNCHES
    start.record()
    out, det = serve_once(model, pyramid, image_sizes)
    end.record()
    torch.cuda.synchronize()
    return det, cuda_fwd.LAUNCHES - before, start.elapsed_time(end)


def mesh_path(smi: str) -> dict:
    """Phase 9b: the full-width two-stage model on a one-rank NCCL mesh,
    through the mesh path (``shard_params``, the attention modules'
    ``shard_map_multiscale_deformable_attention``, ``make_train_step(
    mesh=...)``), against the same model without a mesh: one request's
    detections, then one f32 SGD step's loss and updated parameters.
    Returns every kernel's launches on the mesh path."""
    import tempfile

    import torch.distributed as dist

    store = tempfile.mkdtemp(prefix="msda_mesh_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device_type="cuda")
        image_sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
        pyramid = make_pyramid(REQUEST_SEEDS[0])
        plain = build_model("auto", True)
        sharded = shard_params(build_model("auto", True, mesh=mesh), mesh)
        with torch.inference_mode():
            serve_once(plain, pyramid, image_sizes)  # warm-ups
            reset_launches()
            serve_once(sharded, pyramid, image_sizes)
            served = launches()
            times = {"mesh": [], "unsharded": []}
            for _ in range(3):  # in turns: the request is host-bound
                before = launches()
                got, k1, ms = _mesh_serve(sharded, pyramid, image_sizes)
                after = launches()
                served = {k: served[k] + after[k] - before[k]
                          for k in served}
                times["mesh"].append(ms)
                want, _, ms = _mesh_serve(plain, pyramid, image_sizes)
                times["unsharded"].append(ms)
        check_detections(got)
        worst = max(errors(got[k], want[k])[2] for k in ("scores", "boxes"))
        ok = torch.equal(got["labels"], want["labels"]) and worst <= MESH_TOL
        log(f"mesh (dp=1 sp=1 tp=1, NCCL) request: labels "
            f"{'equal' if torch.equal(got['labels'], want['labels']) else 'DIFFER'}"
            f", scores/boxes err {worst:.3e} (tol {MESH_TOL:g}); K1 {k1} a "
            f"forward; ms in turns, mesh "
            f"{', '.join(f'{t:.3f}' for t in times['mesh'])}, unsharded "
            f"{', '.join(f'{t:.3f}' for t in times['unsharded'])} on {smi}")
        if not ok or k1 != LAUNCHES_PER_FORWARD:
            raise AssertionError("the mesh path's detections or launches "
                                 "differ from the unsharded model's")

        pyramid, targets = make_pyramid(30), make_targets(31)
        results = {}
        for name, model in (("mesh", sharded.train()),
                            ("unsharded", plain.train())):
            step = make_train_step(
                model, torch.optim.SGD(model.parameters(), lr=MESH_LR),
                SLICE_SHAPES, mesh=mesh if name == "mesh" else None,
                **LOSS_KW)
            before = launches()
            loss = step(pyramid, targets).item()
            torch.cuda.synchronize()
            counts = launches()
            results[name] = (loss, {k: counts[k] - before[k]
                                    for k in counts})
        loss_err = abs(results["mesh"][0] - results["unsharded"][0]) / abs(
            results["unsharded"][0])
        # each tensor's difference over its largest value, at least
        # GRAD_FLOOR of the model's largest: a tensor that starts at zero
        # (the MSDA query projections' weights) holds lr x its gradient
        # after the step, whose last bits K2's atomic order sets
        floor = GRAD_FLOOR * max(q.abs().max().item()
                                 for q in plain.parameters())
        worst, worst_name, strict = -1.0, "", 0.0
        for (name, p), q in zip(sharded.named_parameters(),
                                plain.parameters()):
            diff = (p - q).abs().max().item()
            largest = q.abs().max().item()
            strict = max(strict, diff / largest if largest else diff)
            err = diff / max(largest, floor)
            if err > worst:
                worst, worst_name = err, name
        step_counts = results["mesh"][1]
        launched = (step_counts[cuda_fwd.KERNEL],
                    step_counts[cuda_bwd.KERNEL])
        log(f"mesh train step (f32, SGD lr {MESH_LR:g}): loss "
            f"{results['mesh'][0]:.6f}, unsharded "
            f"{results['unsharded'][0]:.6f} (rel {loss_err:.2e}); "
            f"parameters worst {worst:.2e} of the tensor's largest, at "
            f"least {GRAD_FLOOR:g} of the model's largest ({worst_name}; "
            f"tol {MESH_TOL:g}; {strict:.2e} of the tensor's largest "
            f"alone); K1 {launched[0]} K2 "
            f"{launched[1]} a step on {smi}")
        if not (loss_err <= MESH_TOL and worst <= MESH_TOL and launched == (
                LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD)):
            raise AssertionError("the mesh step differs from the unsharded "
                                 "step")
        counts = {k: served[k] + step_counts[k] for k in served}
        # 4 forwards (a warm-up and 3 requests) and one step
        check_path_launches("mesh", counts, {
            cuda_fwd.KERNEL: 5 * LAUNCHES_PER_FORWARD,
            cuda_bwd.KERNEL: LAUNCHES_PER_FORWARD})
        del plain, sharded
        return counts
    finally:
        dist.destroy_process_group()


def hf_parity(smi: str) -> dict:
    """Phase 9c: HF Deformable DETR and Grounding DINO at their published
    configurations, f32, stock against patched with the port's op
    (``detection_parity.run_parity``, one 800x1333 image, a warm-up and 3
    timed requests a side).  Returns every kernel's launches a model."""
    by_path = {}
    for model, path in HF_PATHS.items():
        reset_launches()
        res = detection_parity.run_parity(model, "full", "cuda")
        counts = launches()
        log(f"HF {model} (full, f32): {json.dumps(res)} on {smi}")
        if not (res["k1_launches_per_forward"] == LAUNCHES_PER_FORWARD
                and res["topk_detections_identical"]
                and res["max_abs_boxes_diff"] < detection_parity.BOXES_TOL):
            raise AssertionError(f"HF {model}: parity failed")
        check_path_launches(path, counts, {
            cuda_fwd.KERNEL: 4 * LAUNCHES_PER_FORWARD})
        by_path[path] = counts
    return by_path


def autotune_short(smi: str) -> None:
    """Phase 9d: ``autotune.sweep`` with two candidates a constant, a short
    run: each variant builds, agrees with the plain version and is
    timed."""
    for stream_ in (False, True):
        results = autotune.sweep(stream_, iters=5, per_constant=2,
                                 log=lambda m: log(f"  autotune {m}"))
        failed = [(k, label) for k, times in results.items()
                  for label, ms in times.items() if ms is None]
        if failed:
            raise AssertionError(f"autotune variants failed: {failed}")
    log(f"autotune: every variant built, checked and timed on {smi}")


# Phase 10: the headline lines (python -m msda_tpu_torch.headline), each
# timed over 3 runs of 150 calls after 2 warm-up calls
HEADLINE_CALLS = 2 + 3 * 150


def headline_lines(smi: str) -> dict:
    """Phase 10: ``python -m msda_tpu_torch.headline`` in a subprocess, as a
    user runs it: exit 0 with exactly root ``bench.py``'s three lines, each
    finite.  Returns every kernel's launches in that process (its one
    ``launches`` line on standard error), held to the calls the three lines
    make."""
    run = subprocess.run([sys.executable, "-m", "msda_tpu_torch.headline"],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    lines = [json.loads(line) for line in run.stdout.splitlines()
             if line.startswith("{")]
    want = [f"{name} (cuda)" for name, *_ in headline.CONFIGS]
    if run.returncode != 0 or [line.get("metric") for line in lines] != want \
            or not all(isinstance(line.get("value"), (int, float))
                       and np.isfinite(line["value"]) and line["value"] > 0
                       for line in lines):
        raise AssertionError(f"headline: exit {run.returncode}, lines "
                             f"{lines}\n{run.stderr[-3000:]}")
    for line in lines:
        log(f"headline {json.dumps(line)} on {smi}")
    counts = [json.loads(text[len("launches "):])
              for text in run.stderr.splitlines()
              if text.startswith("launches ")]
    if len(counts) != 1 or set(counts[0]) != set(launches()):
        raise AssertionError(f"headline: launch counts {counts}, expected "
                             f"one line with the keys {sorted(launches())}")
    counts = counts[0]
    fwdbwd = sum(mode == "fwdbwd" for _, _, mode, _ in headline.CONFIGS)
    check_path_launches("headline", counts, {
        cuda_fwd.KERNEL: HEADLINE_CALLS * len(headline.CONFIGS),
        cuda_bwd.KERNEL: HEADLINE_CALLS * fwdbwd})
    log(f"headline: launches {counts} in its process on {smi}")
    return counts


def main() -> None:
    smi = setup()
    errs = {cuda_fwd.KERNEL: check_kernel(),
            cuda_bwd.KERNEL: check_backward_kernel(),
            **check_stream_kernels()}
    check_model_parity()
    check_gradient_parity()
    served, serve_ms = serve(smi)
    trained, per_train_step, train_ms = train(smi)
    by_path = {"serve": served, "train": trained,
               **large_pyramid_path(smi)}
    times = {cuda_fwd.KERNEL: time_kernel(smi),
             cuda_bwd.KERNEL: time_backward_kernel(smi)}
    time_big_pyramid(smi)
    stream_times = time_stream_kernels(smi)
    sweep_pyramids(smi)
    benchmark_row(smi)
    opcheck_on_card()
    by_path["export"] = export_path(smi, serve_ms)
    profile_paths(smi, serve_ms, train_ms)
    entry_points(smi)
    dryrun_cpu(smi)
    by_path["mesh"] = mesh_path(smi)
    by_path.update(hf_parity(smi))
    autotune_short(smi)
    by_path["headline"] = headline_lines(smi)
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        if name in times:  # K1, K2: the encoder shape, f32
            ms, plain_ms, b = times[name][("encoder", torch.float32)]
        else:  # the streamed kernels: the 256-base pyramid, f32
            ms, plain_ms, b = stream_times[(name, torch.float32)]
        paths = {path: counts[name] for path, counts in by_path.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "launches_per_train_step": per_train_step[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b["ms"],
            "bound_by": b["bound_by"],
            # no single PyTorch call computes MSDA (grid_sample per level,
            # then the weights, then a sum) or the binning
            "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
