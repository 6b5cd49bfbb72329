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
      with out-of-bounds points and a skewed case with every point in one
      band; f32, bf16 and f16; every padding_mode x align_corners;
   b. the path: ``multiscale_deformable_attention(impl="auto")`` forward
      and backward at the 256-base pyramid, which the L2 router sends to
      the streamed kernels only (launches counted), against the plain
      versions;
   c. K3' against K1 and K4' + K5' against K2, in turns with the plain
      versions, at the 256-base pyramid in f32 and bf16;
   d. a sweep over pyramid bases 64, 128, 256 and 512 (B=4, N=10,000, f32
      and bf16): streamed against resident kernels, and the router's
      choice, at each size;
   e. one ``--pyramid big`` run of ``python -m msda_tpu_torch.benchmark``
      at N=10,000.

Any failure raises, and the script exits non-zero.  The line before the
last is a JSON summary of the kernels (launches on the main paths and per
training step, error, time, plain time and bound at the encoder shape for
K1/K2 and at the 256-base pyramid for the streamed kernels); the last line
is ``{"ok": true, "device": {...}}``.
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

from msda_tpu_torch import benchmark  # noqa: E402
from msda_tpu_torch.models import DeformableDetr, init_parameters, postprocess  # noqa: E402
from msda_tpu_torch.ops import _build, cuda_bwd, cuda_fwd, cuda_stream, stream  # noqa: E402
from msda_tpu_torch.ops import multiscale_deformable_attention as msda  # noqa: E402
from msda_tpu_torch.ops import native_msda_backward as plain_msda_bwd  # noqa: E402
from msda_tpu_torch.ops import native_multiscale_deformable_attention as plain_msda  # noqa: E402
from msda_tpu_torch.parallel import detection_loss, make_train_step  # noqa: E402
from msda_tpu_torch.utils import (msda_bound, reference_workload,  # noqa: E402
                                  roofline_ms, touched_rows)

# Deformable DETR (Zhu et al., arXiv:2010.04159 §4, App. A): an 800x1333
# image at strides 8/16/32/64, ResNet-50 C3-C5 + one extra level.
SLICE_SHAPES = ((100, 167), (50, 84), (25, 42), (13, 21))
IN_CHANNELS = (512, 1024, 2048, 2048)
IMAGE_HW = (800, 1333)
BATCH = 2
MODEL = dict(num_classes=91, in_channels=IN_CHANNELS, emb_dim=256,
             num_heads=8, num_points=4, num_queries=300,
             num_encoder_layers=6, num_decoder_layers=6, ffn_dim=1024,
             with_box_refinement=True)
LAUNCHES_PER_FORWARD = 12  # 6 encoder + 6 decoder layers
# the reference workload of the benchmarks (msda_tpu/utils/bench.py)
REF_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
# scripts/benchmark.py --pyramid big: I = 87,040, 356 MB of f32 img at B=4
BIG_SHAPES = ((256, 256), (128, 128), (64, 64), (32, 32))
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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


def make_pyramid(seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (BATCH, h, w, c), dtype=np.float32)).to(DEVICE)
        for (h, w), c in zip(SLICE_SHAPES, IN_CHANNELS)]


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
                remat=False):
    model = DeformableDetr(**MODEL, two_stage=two_stage, impl=impl,
                           compute_dtype=compute_dtype, remat=remat,
                           device=DEVICE)
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


def serve(smi: str) -> dict:
    """Phase 4: the main path.  Returns every kernel's launch count."""
    image_sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
    requests = [make_pyramid(20 + i) for i in range(3)]
    models = {"f32": build_model("auto", True),
              "bf16": build_model("auto", True, torch.bfloat16)}
    torch.cuda.synchronize()

    reset_launches()
    forwards = 0
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
    return counts


def train(smi: str) -> tuple[dict, dict]:
    """Phase 5: the main path of the backward.  Returns every kernel's
    launches over the training run and in one f32 step (no remat)."""
    pyramid, targets = make_pyramid(30), make_targets(31)
    reset_launches()
    steps, per_step = 0, {}
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
    return counts, per_step


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
# pyramid with a ragged N, out-of-bounds points and several bands; and a
# skewed case with every point in one band of level 0 (a bin of all 40,000
# samples of each (b, h, level), served in slices).
STREAM_CASES = {
    "big_pyramid": dict(shapes=BIG_SHAPES, B=4, N=10000, H=8, C=32, P=4,
                        seed=50, plan=None),
    "small_bands": dict(shapes=((30, 27), (15, 14), (8, 7), (4, 3)), B=2,
                        N=3037, H=8, C=32, P=4, seed=51,
                        plan=((4, 5), (3, 100), (2, 2), (1, 1))),
    "ragged_oob": dict(shapes=REF_SHAPES, B=2, N=1037, H=8, C=32, P=4,
                       seed=52, oob=True,
                       plan=((5, 64), (4, 9), (3, 16), (8, 8))),
    "skewed": dict(shapes=REF_SHAPES, B=1, N=10000, H=8, C=32, P=4, seed=53,
                   skew=True, plan=((8, 64), (8, 32), (8, 16), (8, 8))),
}
SWEEP_BASES = (64, 128, 256, 512)


def stream_inputs(shapes, B, N, H, C, P, seed, oob=False, skew=False,
                  plan=None):
    """``op_inputs`` (with out_grad); ``skew`` puts every point's y in
    [0.40, 0.41), one band of each level."""
    img, pts, wts, og = op_inputs(shapes, B, N, H, C, P, seed, oob=oob,
                                  out_grad=True)
    if skew:
        pts[..., 1] = 0.40 + 0.01 * pts[..., 1]
    return img, pts, wts, og


def check_bins(name, case, pts) -> float:
    """The binning kernels against ``stream.sample_bins``: the same count in
    every bin, and ``order`` a permutation of the samples, bin by bin.
    Returns the largest difference of a bin's count."""
    shapes = case["shapes"]
    plan = stream.check_plan(shapes, case["plan"], case["C"], torch.float32)
    order, _, counts = cuda_stream.bin_samples(pts, shapes, plan)
    torch.cuda.synchronize()
    bins = stream.sample_bins(pts, shapes, plan).flatten()
    want = torch.bincount(bins, minlength=counts.numel())
    ok = (torch.equal(counts.long(), want)
          and torch.equal(torch.sort(order.long()).values,
                          torch.arange(order.numel(), device=DEVICE))
          and torch.equal(bins[order.long()], torch.repeat_interleave(
              torch.arange(counts.numel(), device=DEVICE), want)))
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
        bin_err = check_bins(name, case, pts)
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


def large_pyramid_path(smi: str) -> dict:
    """Phase 7b: the op at the 256-base pyramid through impl="auto", forward
    and backward, 1 + 3 times; the router must send both to the streamed
    kernels.  Returns every kernel's launch count over the run."""
    img, shapes, pts, wts, og = reference_workload(
        10000, torch.float32, BIG_SHAPES, seed=60, device=DEVICE)
    _, _, H, C = img.shape
    l2 = stream.l2_bytes(DEVICE)
    routes = (stream.use_streaming_fwd(shapes, H, C, img.dtype, l2),
              stream.use_streaming_bwd(shapes, H, C, img.dtype, l2))
    size = stream.image_bytes(shapes, H, C, img.dtype)
    log(f"large-pyramid path: one image's pyramid {size} bytes, L2 {l2} "
        f"bytes; streams (fwd, bwd) {routes}")
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
    check_path_launches("large-pyramid path", counts, {
        "msda_stream_fwd": steps, "msda_stream_bwd": steps,
        "msda_stream_bin": 2 * steps})
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
    log(f"large-pyramid path (B=4, N=10000, f32, {mode[0]}, ac="
        f"{int(mode[1])}): fwd+bwd ms {', '.join(f'{t:.3f}' for t in times)}"
        f" (first is the warm-up); launches {counts}; vs plain max_abs/err "
        f"{'; '.join(report)} {'ok' if ok else 'FAIL'} on {smi}")
    if not ok:
        raise AssertionError("the large-pyramid path disagrees with the "
                             "plain versions")
    return counts


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
                   lambda: cuda_stream.bin_samples(pts32, BIG_SHAPES, plan),
                   None)
        # the binning reads the points and writes order (one int32 per
        # sample), counts and starts (one int32 per bin each)
        B, N, H, L, P, _ = pts.shape
        C = img.shape[-1]
        bins = B * H * stream.num_bins(BIG_SHAPES, plan)
        bin_bytes = pts32.numel() * 4 + pts32.numel() // 2 * 4 + 2 * bins * 4
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


def sweep_pyramids(smi: str) -> None:
    """Phase 7d: streamed against resident kernels over pyramid sizes, in
    turns (resident, streamed, streamed, resident), and the router's
    choice at each size."""
    for base in SWEEP_BASES:
        shapes = tuple((base >> i, base >> i) for i in range(4))
        for dtype in (torch.float32, torch.bfloat16):
            img, _, pts, wts, og = reference_workload(
                10000, dtype, shapes, seed=70, device=DEVICE)
            H, C = img.shape[2], img.shape[3]
            l2 = stream.l2_bytes(DEVICE)
            routes = ("stream" if stream.use_streaming_fwd(
                shapes, H, C, dtype, l2) else "K1",
                "stream" if stream.use_streaming_bwd(
                    shapes, H, C, dtype, l2) else "K2")
            row = []
            for resident, streamed in (
                    (lambda: cuda_fwd.msda_fwd(img, shapes, pts, wts),
                     lambda: cuda_stream.msda_stream_fwd(img, shapes, pts,
                                                         wts)),
                    (lambda: cuda_bwd.msda_bwd(img, shapes, pts, wts, og),
                     lambda: cuda_stream.msda_stream_bwd(img, shapes, pts,
                                                         wts, og))):
                r1 = time_ms(resident, 10)
                s1 = time_ms(streamed, 10)
                s2 = time_ms(streamed, 10)
                r2 = time_ms(resident, 10)
                row.append(((r1 + r2) / 2, (s1 + s2) / 2))
            (k1, k3), (k2, k45) = row
            log(f"sweep base {base:3d} (I={img.shape[1]}, img "
                f"{img.numel() * img.element_size() / 1e6:.1f} MB) "
                f"{str(dtype)[6:]:8s}: fwd K1 {k1:.4f} / streamed {k3:.4f} ms"
                f" ({k1 / k3:.2f}x), bwd K2 {k2:.4f} / streamed {k45:.4f} ms "
                f"({k2 / k45:.2f}x); router picks {routes} on {smi}")
            del img, pts, wts, og


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


def main() -> None:
    smi = setup()
    errs = {cuda_fwd.KERNEL: check_kernel(),
            cuda_bwd.KERNEL: check_backward_kernel(),
            **check_stream_kernels()}
    check_model_parity()
    check_gradient_parity()
    served = serve(smi)
    trained, per_train_step = train(smi)
    by_path = {"serve": served, "train": trained,
               "large_pyramid": large_pyramid_path(smi)}
    times = {cuda_fwd.KERNEL: time_kernel(smi),
             cuda_bwd.KERNEL: time_backward_kernel(smi)}
    time_big_pyramid(smi)
    stream_times = time_stream_kernels(smi)
    sweep_pyramids(smi)
    benchmark_row(smi)
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
