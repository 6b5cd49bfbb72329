#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``msda_tpu_torch``) once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; there is no CPU mode.  The phases:

1. Setup: print the card's name and power limit, turn TF32 off, build the
   CUDA kernels (K1 forward, K2 backward, the streamed K3' forward and
   K4' + K5' backward with their binning, the auction matcher and the
   fused residual add + LayerNorm) from
   ``msda_tpu_torch/csrc``, one ``nvcc`` per source, started together, and
   print the build time and each kernel's registers and spills.
2. Kernels vs plain versions: K1 against
   ``native_multiscale_deformable_attention`` and K2 against
   ``native_msda_backward`` on the same seeded inputs, at the reference
   workload, Deformable DETR's encoder and decoder shapes and a ragged N
   with out-of-bounds points; f32, bf16 and f16; every padding_mode x
   align_corners.  Both also (``BWD_CASES``): C = 30 with a ragged N and
   out-of-bounds points, C = 160, every point of each (b, h) at one place
   on every level (K2's exact adds of merged runs, ``csrc/msda_bwd.cu``),
   and the model's own points at the encoder shape.  K1 also
   (``fwd_edge_cases``): N of T - 1, T, T + 1 and 2T + 1 queries a head
   for its tile of T tasks, one level of 3 points, 16 levels of one point,
   and 16 levels of 4 points at C = 160 (``csrc/msda_fwd.cu``).  K2 also
   (``bwd_edge_cases``): T - 1, T, T + 1 and 2T + 1 tasks for its tile of
   T, the same odd rows and chunks (at C = 160 with channel steps), and
   points and weights off an 8-byte boundary (``csrc/msda_bwd.cu``).
3. Model parity: the full-width Deformable DETR (box refinement, no
   two-stage, so that no top-k can flip on a near tie) with impl="cuda"
   against impl="reference", same weights, f32: the outputs, then the
   loss and every parameter's gradient (fixed matcher, so that no auction
   can flip on a near tie either).
4. Serving, the main path: the full-width two-stage model's request
   (forward + postprocess, batch 2) through a user's serving function
   captured per input signature as a CUDA graph (``utils.graphs.
   graphed``), under inference_mode, in f32 and in bf16: a warm-up, the
   capture (and its replay), then 3 replays, each beside the eager request
   (``__wrapped__``) in turns; each request must launch K1's prologue
   variant (``msda_fwd_queries``) 12 times and K1 none (a replay adds the
   captured launches to the counters).
4b. The graphed request against the eager one on the same inputs, f32 and
   bf16: the capture's replay on request a and a replay on request b, each
   with labels equal and scores and boxes within 1e-5 (f32) or 1e-2 (bf16)
   of max(1, |eager|), eager against eager printed beside; b's detections
   must differ from a's (the replay reads its new inputs); a second
   signature, batch 1 at 800x1333, with a capture of its own, held the
   same way; one eager request under ``torch.cuda.set_sync_debug_mode(
   "error")`` with ``image_sizes`` on the card (no host sync); peak
   allocated memory of the eager request, the capture, a replay and the
   second signature's capture.
4c. Serving over many input sizes (``serve_shapes``): the full-width
   two-stage model, batch 2, f32 and bf16, through one graphed serving
   function (its level shapes those of the pyramid) at the eight input
   sizes of Deformable DETR's evaluation resize (shorter side 800, longer
   at most 1333): each size's warm-up and capture (one memory pool), two
   round-robin passes of replays on new seeded inputs, each held to the
   eager request (labels equal, scores and boxes within 4b's bars) and
   differing from its size's previous replay, three timed replays at
   800x1333 beside phase 4's mean; the reserved and allocated growth over
   the eight captures beside eight separate graphed functions (a pool
   each, the control), one pool at most half the control's reserved
   growth in f32; in f32 a run with ``max_signatures=4`` over the sizes
   in blocks (32 calls, 12 captures), every call held to the eager
   request, never more than 4 signatures kept.
5. Training, the main path of the backward: the full-width two-stage model,
   batch 2, focal loss + auction matcher + aux and proposal losses,
   AdamW(capturable=True), through ``make_train_step``, whose step on a
   card is captured as a CUDA graph: one warm-up step, the capture (and its
   replay) and 4 replays on a fixed synthetic batch, in f32 and in bf16,
   then the warm-up, the capture and one replay with remat=True.  Each
   step must launch K1 12 times (24 with remat), K2 12 times and the
   auction kernel 6 times (a replay adds the captured step's launches to
   the counters); the losses must be finite and fall.
5b. The auction kernel and the graphed step:
   a. the auction kernel against ``matcher.plain_auction`` at (B, N, M) =
      (2, 300, 50), (16, 300, 50) and (2, 900, 300) (the last past shared
      memory): uniform, quantised (ties), constant and masked (5-9 of the
      target slots real) costs; a square (2, 64, 64) cost with 2000, 1, 3
      and 17 rounds; and the 6 costs of one f32 step of phase 5's batch:
      ``query_idx`` and ``converged`` equal, each case's time beside the
      plain loop's and the rounds it took;
   b. one eager step under ``torch.cuda.set_sync_debug_mode("error")``: no
      host sync;
   c. the graphed step against the eager one on phase 5's model, f32 and
      bf16.  Each SGD call (the capture's replay on phase 5's batch, then
      a replay on a second batch of the same shapes) and 5 AdamW replays
      are held to an eager step from copies of the same parameters and
      optimizer state: the loss within 1e-5 relative (f32) or 1e-2
      (bf16); the update within 1e-3 (f32) or 0.1 (bf16) of the eager
      update's 2-norm, where a step that updates nothing reads 1 and the
      other batch's step must read above the bar too; in f32 every
      parameter after an SGD step within phase 9b's 1e-6 of the floored
      scale, and the same for one f32 SGD call with remat=True.  A warm-up and 5 AdamW steps run freely: losses finite and
      falling, the first update's within the loss bar of the eager run's,
      with ``max_memory_allocated`` over each run;
   d. one f32 replay under ``utils.profile.trace``: 12 K1, 12 K2 and 6
      auction launches in the trace, the busy time and the idle share;
   e. the step's time, eager and graphed in turns, f32 and bf16.
5c. Training over input sizes with a schedule (``train_shapes``): the
   full-width two-stage model's graphed step, f32, batch 2, one step
   (``img_shapes=None``) at three sizes of the training resize, (480,
   800), (640, 1067) and (800, 1333), called in turns for three rounds;
   AdamW with a tensor lr on the card under a linear warm-up
   (``LambdaLR``, stepped after every call): one capture a size; every
   call held to an eager step from copies of the same parameters and
   optimizer state, lr included (5b c's bars); the host syncs of
   ``scheduler.step()`` counted (``set_sync_debug_mode("warn")``); the
   reserved growth over the captures below that of three separate steps,
   a pool each.
5d. Two-stage Deformable DETR as published (``two_stage="published"``),
   which matches its targets over every encoder token:
   a. the auction's large-N path (``cuda_auction_large``: transpose,
      select, compaction, then the auction kernel on the smaller problem)
      against ``matcher.plain_auction`` over the whole cost, on the same
      card tensors, at (B, N, M) = (2, 22223, 50) (800x1333 at batch 2)
      and (1, 88750, 50) (1600x2666, where the select kernel reads a
      target's costs from the L2 on each pass): masked (5-9 of the target
      slots real), masked with quantised costs (ties) and uniform costs
      (all 50 real); ``query_idx`` and ``converged`` equal, every case
      converged, ``auction_assignment`` routing each to the path (one call,
      and no launch of the shared-memory path); each case's time beside
      the plain loop's and the bound (the cost read once);
   b. the published form's graphed step, f32, batch 2 at 800x1333, AdamW
      (capturable), phase 5's batch: a warm-up, the capture and its
      replay, then replays; each step must launch K1 12 times, K2 12
      times, the auction kernel 6 times (the decoder's heads) and the
      large-N path once (the proposals), read from that run's counters;
      the matchings converged, the losses finite and falling.
6. Timing: K1 and K2 against their plain versions, in turns, each beside
   its bound (``utils.bench.msda_bound``: the least time the card could
   take, from the bytes the call must move and the operations it must do,
   with ``img`` counted in the rows the points reach), at the encoder, the
   decoder and the reference workload, f32 and bf16; K2's device time by
   kernel (the kernel, img_grad's memset and the casts) under the
   profiler, and its bf16 time over its f32 time; then K1 and K2 alone at
   the 256-base pyramid (I = 87,040), beyond the card's L2.
6b. The fused residual add + LayerNorm (``ops/cuda_norm.py``) against its
   plain version, the four-call chain ``add_layer_norm_plain``, on the
   same card tensors, bf16 and f16, at the 800x1333 encoder call's 44,446
   rows and the decoder's 600, D = 256: at least 99% of the outputs
   bitwise equal and none more than one ulp of the output dtype apart
   (taken at the output's magnitude, no finer than at 2**-10, as
   ``tests/test_torch_norm.py``); each side's device time, a call of a
   CUDA graph of ``NORM_CALLS`` calls replayed, beside the bound (6 D
   bytes a row at 3.35 TB/s).
6c. K1's prologue variant (``ops/cuda_fwd_queries.py``) on the
   full-width model's own calls at 800x1333 (encoder layer 0, decoder
   layer 0), bf16 and f32: against its plain version
   (``msda_fwd_queries_plain``) within K1's ``TOL``, the JSON row's
   ``max_abs_err`` (f32, as K1's); against the module's chain
   (``sampling_plain``) + K1 within one output ulp (the share bitwise
   equal, the row's ``chain_k1_*``); in f32, each one's distance to the
   f64 path (``f64_gap``); each side's device time, a call of a CUDA graph
   of ``QUERIES_GRAPH_CALLS`` calls replayed, in turns, beside the bound
   (q, the reference points, img's reached rows, the output) and the plain
   version's time.
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
   b. the op's two paths: ``multiscale_deformable_attention(impl="auto")``
      forward and backward at the 512-base pyramid, unforced (K1 and K2),
      and with ``stream.forced()`` at the 256-base pyramid (both
      streamed); launches counted, results against the plain versions;
   c. K3' against K1 and K4' + K5' against K2, in turns with the plain
      versions, at the 256-base pyramid in f32 and bf16;
   d. one ``--pyramid big`` run of ``python -m msda_tpu_torch.benchmark``
      at N=10,000.
8. Export and profiling (``ops/library.py``, ``utils/export.py``,
   ``utils/profile.py``):
   a. ``torch.library.opcheck`` of the operators
      ``torch.ops.msda_tpu_torch.msda_fwd`` and ``msda_bwd`` on CUDA
      tensors at the decoder's shapes, f32 and bf16, both paddings;
   b. the full-width two-stage model's forward + postprocess exported with
      ``utils.export.export_fn`` (which traces without autograd, so the
      bf16 program calls the fused add + LayerNorm, 30 a request, as the
      live request does) in f32 and bf16 and saved under
      ``build/export_smoke/``; a second Python process, which imports
      torch, numpy and ``msda_tpu_torch.utils.export`` only, loads the
      artifacts with ``load_exported_file`` (the program graphed) and
      serves a warm-up, the capture and phase 4's 3 requests, graphed and
      eager (``__wrapped__``, the program node by node) in turns, each
      request launching K1's prologue variant 12 times and K1 none; its
      graphed detections against the
      live graphed request's (labels equal, scores and boxes within 1e-5
      f32, 1e-2 bf16), its graphed mean at most 2x phase 4's live graphed
      mean, the eager mean beside it;
   c. one f32 serving request, eager (``__wrapped__``) and graphed (a
      replay: 12 of K1's prologue variant in the trace, no K1), one replay
      of the exported bf16 program
      (the device time of its copy kernels, the weight casts among them)
      and one eager f32 training step (``step.__wrapped__``) under
      ``utils.profile.trace``: the window, device busy time and idle
      share, the 10 kernels with the most device time, and the spans
      (encoder, decoder, postprocess; loss + matcher, backward, optimizer),
      beside 5b's graphed replay;
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
   d. ``autotune.sweep`` with two candidates a constant (K1's
      ``MSDA_FWD_*`` and K2's ``MSDA_BWD_*``; the streamed kernels'
      ``STREAM_SLICE``, ``FWD_``/``BWD_CHUNKS_PER_BLOCK``), a short run:
      each variant builds, agrees with its plain version and is timed.
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
and bound at the encoder shape for K1/K2, at the 256-base pyramid for
the streamed kernels, on the costs of a step's first head for the
auction kernel, and at the 800x1333 encoder call in bf16 for the fused
add + LayerNorm and K1's prologue variant); the last line is ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from msda_tpu_torch import autotune, benchmark, capture_trace, detection_parity, headline, memory_report  # noqa: E402
from msda_tpu_torch.models import DeformableDetr, attention, init_parameters, postprocess  # noqa: E402
from msda_tpu_torch.models.detr import LAYER_NORM_EPS  # noqa: E402
from msda_tpu_torch.ops import _build, cuda_bwd, cuda_fwd, cuda_fwd_queries, cuda_norm, cuda_stream, library, stream  # noqa: E402
from msda_tpu_torch.ops import multiscale_deformable_attention as msda  # noqa: E402
from msda_tpu_torch.ops import native_msda_backward as plain_msda_bwd  # noqa: E402
from msda_tpu_torch.ops import native_multiscale_deformable_attention as plain_msda  # noqa: E402
from msda_tpu_torch.parallel import cuda_auction_large, cuda_matcher, detection_loss, make_mesh, make_train_step, shard_params  # noqa: E402
from msda_tpu_torch.parallel import train as train_module  # noqa: E402
from msda_tpu_torch.parallel.matcher import auction_assignment, plain_auction  # noqa: E402
from msda_tpu_torch.ops.launches import counts as launches  # noqa: E402
from msda_tpu_torch.ops.launches import reset as reset_launches  # noqa: E402
from msda_tpu_torch.utils import graphs as graphs_module  # noqa: E402
from msda_tpu_torch.utils import (card_identity, export_fn,  # noqa: E402
                                  graphed, load_exported_file, msda_bound,
                                  reference_workload, roofline_ms,
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
MODEL = dict(num_classes=91, in_channels=IN_CHANNELS, emb_dim=256,
             num_heads=8, num_points=4, num_queries=300,
             num_encoder_layers=6, num_decoder_layers=6, ffn_dim=1024,
             with_box_refinement=True)
# 6 encoder + 6 decoder layers: K1's launches a forward that autograd
# records (training) or that runs on a mesh; an inference forward launches
# K1's prologue variant (msda_fwd_queries) as many times and K1 none
LAUNCHES_PER_FORWARD = 12
# the fused add + LayerNorm's launches a bf16 forward without autograd: two
# an encoder layer, three a decoder layer (an f32 forward or one autograd
# records launches none)
NORMS_PER_HALF_FORWARD = 2 * 6 + 3 * 6
# the reference workload of the benchmarks (msda_tpu/utils/bench.py)
REF_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
# the most levels the kernels take, 64x48 down to 8x6 (phase 2's K1 cases)
SIXTEEN_LEVELS = tuple((64 >> (lvl // 4), 48 >> (lvl // 4))
                       for lvl in range(16))
# scripts/benchmark.py --pyramid big: I = 87,040, 356 MB of f32 img at B=4
BIG_SHAPES = ((256, 256), (128, 128), (64, 64), (32, 32))
# the 512-base pyramid, past the L2, where an unforced call still runs K1
# and K2 (phase 7b)
PATH_SHAPES = tuple((512 >> i, 512 >> i) for i in range(4))
# training: 50 target slots per image, a seeded ~7 of them real (COCO's
# mean); the Deformable DETR optimizer (AdamW, lr 2e-4, weight decay 1e-4)
TARGET_SLOTS = 50
TRAIN_STEPS = 5
# the auction kernel's launches a step: the final head and the 5 aux heads
# of box refinement (the proposal loss matches by nearest anchor)
AUCTIONS_PER_STEP = 6
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
    # K1 from the query projection's output: the module's sampling-point
    # and softmax chain (XLA's elementwise fusions in the JAX model) and K1
    cuda_fwd_queries.KERNEL: (
        cuda_fwd_queries, "msda_tpu_torch/csrc/msda_fwd.cu",
        "msda_tpu/ops/pallas_fwd.py:440 + the chain before it, "
        "msda_tpu/models/attention.py"),
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
    # no Pallas kernel: the XLA while_loop of the JAX matcher
    cuda_matcher.KERNEL: (cuda_matcher, "msda_tpu_torch/csrc/msda_auction.cu",
                          "msda_tpu/parallel/matcher.py:71"),
    cuda_norm.KERNEL: (cuda_norm, "msda_tpu_torch/csrc/msda_norm.cu",
                       "none: XLA's fusion of nn.LayerNorm()(x + y), "
                       "msda_tpu/models/detr.py:80"),
    # the auction past MAX_SLOTS: a transpose, a select, a compaction, then
    # the auction kernel on the smaller problem (one call, four launches)
    cuda_auction_large.KERNEL: (
        cuda_auction_large, "msda_tpu_torch/csrc/msda_auction.cu",
        "none: the JAX loss assigns by nearest anchor"),
}
LIBRARIES = (cuda_fwd.KERNEL, cuda_bwd.KERNEL, cuda_stream.LIBRARY,
             cuda_matcher.KERNEL, cuda_norm.KERNEL)


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
    for module in (cuda_fwd, cuda_bwd, cuda_stream, cuda_matcher, cuda_norm):
        module.load()
    log(f"build: {', '.join(LIBRARIES)} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    # one register/spill report per kernel instantiation
    for name in LIBRARIES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def check_path_launches(path: str, counts: dict, expected: dict) -> None:
    """Fail unless the path launched exactly ``expected`` (and no other
    kernel; a kernel missing from ``counts`` launched nothing)."""
    names = set(counts) | set(expected)
    got = {name: counts.get(name, 0) for name in names}
    want = {name: expected.get(name, 0) for name in names}
    if got != want:
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


def fwd_edge_cases() -> dict:
    """K1's own cases: N of T - 1, T, T + 1 and 2T + 1 queries a head (T
    the tile of K1's launch at C = 32: tile ends inside a head, on its end,
    past it, and a ragged last tile), one level of 3 points (rows of 24 and
    12 bytes: 8- and 4-byte copies), 16 levels of one point, and 16 levels
    of 4 points at C = 160 (two chunks of points, two channel passes)."""
    probe = op_inputs(REF_SHAPES, B=1, N=1, H=8, C=32, P=4, seed=0)
    T = cuda_fwd.launch_plan(probe[0], REF_SHAPES, *probe[1:])["tile"]
    cases = {f"tile_n{n}": dict(shapes=REF_SHAPES, B=1, N=n, H=8, C=32, P=4,
                                seed=40 + i, oob=True)
             for i, n in enumerate((T - 1, T, T + 1, 2 * T + 1))}
    cases["l1_p3"] = dict(shapes=((37, 53),), B=2, N=301, H=8, C=32, P=3,
                          seed=44, oob=True)
    cases["l16_p1"] = dict(shapes=SIXTEEN_LEVELS, B=2, N=301, H=8, C=32,
                           P=1, seed=45, oob=True)
    cases["l16_p4_c160"] = dict(shapes=SIXTEEN_LEVELS, B=2, N=97, H=4,
                                C=160, P=4, seed=46, oob=True)
    return cases


def check_kernel() -> float:
    """Phase 2, K1 against its plain version on ``OP_CASES``, K2's own cases
    (``BWD_CASES`` and the model's points) and ``fwd_edge_cases``; returns
    the largest f32 abs error at the encoder shape."""
    enc_f32_err = 0.0
    edges = fwd_edge_cases()
    for name in (*BACKWARD_CASES, *edges):
        if name in edges:
            shapes = edges[name]["shapes"]
            img32, pts, wts = op_inputs(**edges[name])
        else:
            shapes, img32, pts, wts, _ = bwd_case_inputs(name)
        for dtype, tol in TOL.items():
            img = img32.to(dtype)
            for padding_mode, align_corners in MODES:
                got = cuda_fwd.msda_fwd(img, shapes, pts, wts,
                                        padding_mode, align_corners)
                torch.cuda.synchronize()
                want = plain_msda(img, shapes, pts, wts,
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


# K2's own cases: C = 30 (not a multiple of 4: one channel a lane) with a
# ragged N and out-of-bounds points; C = 160 (past G * VEC = 128: channel
# steps, so K2 adds point by point); every point of each (b, h) at one
# place on every level of the encoder's pyramid, 88,892 points on one
# corner set a level (where one f32 atomic a point missed the 1e-4 bar:
# K2's exact adds of a query's merged points are what hold it); and the
# model's own points at the encoder shape (encoder layer 0's call of the
# full-width model at 800x1333, batch 2).
BWD_CASES = {
    "c30_ragged_oob": dict(shapes=REF_SHAPES, B=2, N=1037, H=8, C=30, P=4,
                           seed=5, oob=True),
    "c160": dict(shapes=REF_SHAPES, B=2, N=517, H=8, C=160, P=4, seed=6),
    "hot_pixel": dict(shapes=SLICE_SHAPES, B=BATCH,
                      N=sum(h * w for h, w in SLICE_SHAPES), H=8, C=32, P=4,
                      seed=7),
}
BACKWARD_CASES = (*OP_CASES, *BWD_CASES, "encoder_model")


def bwd_case_inputs(name: str):
    """``(shapes, img, pts, wts, out_grad)`` of one of phase 2's K2 cases,
    f32 on the card."""
    if name == "encoder_model":
        img, shapes, pts, wts = model_call(IMAGE_HW, BATCH, 0)
        rng = np.random.default_rng(8)
        og = torch.from_numpy(rng.standard_normal(
            (img.shape[0], pts.shape[1], img.shape[2], img.shape[3]),
            dtype=np.float32)).to(DEVICE)
        return shapes, img, pts, wts, og
    if name.startswith("bwd_"):  # bwd_edge_cases
        case = bwd_edge_cases()[name]
        img, pts, wts, og = op_inputs(**case, out_grad=True)
        if name == "bwd_misaligned":
            pts, wts = misaligned(pts), misaligned(wts)
        return case["shapes"], img, pts, wts, og
    case = {**OP_CASES, **BWD_CASES}[name]
    img, pts, wts, og = op_inputs(**case, out_grad=True)
    if name == "hot_pixel":  # one place on every level
        pts = torch.tensor([0.37, 0.61], device=DEVICE).expand_as(pts)
        pts = pts.contiguous()
    return case["shapes"], img, pts, wts, og


def bwd_edge_cases() -> dict:
    """K2's own cases: T - 1, T, T + 1 and 2T + 1 tasks (one head of that
    many queries; T the tile of K2's launch at C = 32: the launch's end
    inside a tile, on its end, past it, and a ragged last tile), one level
    of 3 points (8- and 4-byte copies), 16 levels of one point, 16 levels
    of 4 points at C = 160 (two chunks of points, channel steps) and
    points and weights off an 8-byte boundary (4-byte copies)."""
    probe = op_inputs(REF_SHAPES, B=1, N=1, H=8, C=32, P=4, seed=0,
                      out_grad=True)
    T = cuda_bwd.launch_plan(probe[0], REF_SHAPES, *probe[1:])["tile"]
    cases = {f"bwd_tile_t{n}": dict(shapes=REF_SHAPES, B=1, N=n, H=1, C=32,
                                    P=4, seed=50 + i, oob=True)
             for i, n in enumerate((T - 1, T, T + 1, 2 * T + 1))}
    cases["bwd_l1_p3"] = dict(shapes=((37, 53),), B=2, N=301, H=8, C=32,
                              P=3, seed=54, oob=True)
    cases["bwd_l16_p1"] = dict(shapes=SIXTEEN_LEVELS, B=2, N=301, H=8,
                               C=32, P=1, seed=55, oob=True)
    cases["bwd_l16_p4_c160"] = dict(shapes=SIXTEEN_LEVELS, B=2, N=97, H=4,
                                    C=160, P=4, seed=56, oob=True)
    cases["bwd_misaligned"] = dict(shapes=REF_SHAPES, B=2, N=77, H=8, C=32,
                                   P=4, seed=57, oob=True)
    return cases


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts one element past an
    allocation (off an 8-byte boundary)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_backward_kernel() -> float:
    """Phase 2, K2 on ``BACKWARD_CASES`` and ``bwd_edge_cases``; returns the
    largest f32 abs error (over the three gradients) at the encoder
    shape."""
    return check_backward_cases((*BACKWARD_CASES, *bwd_edge_cases()))


def check_backward_cases(names) -> float:
    """K2 against ``native_msda_backward`` on ``names`` in every dtype and
    mode; returns the largest f32 abs error at the encoder shape."""
    enc_f32_err = 0.0
    for name in names:
        shapes, img32, pts, wts, og32 = bwd_case_inputs(name)
        for dtype in TOL:
            img, og = img32.to(dtype), og32.to(dtype)
            for padding_mode, align_corners in MODES:
                got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og,
                                        padding_mode, align_corners)
                torch.cuda.synchronize()
                want = plain_msda_bwd(img, shapes, pts, wts, og,
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
                log(f"K2 {name:18s} {str(dtype)[6:]:8s} "
                    f"{padding_mode:6s} ac={int(align_corners)}: max_abs/err "
                    f"{'; '.join(report)} {'ok' if ok else 'FAIL'}")
                if not ok:
                    off = 0
                    for lvl, (h, w) in enumerate(shapes):
                        part = errors(got[0][:, off:off + h * w],
                                      want[0][:, off:off + h * w])
                        log(f"  img_grad level {lvl} ({h}x{w}): max_abs "
                            f"{part[0]:.2e} err {part[2]:.2e}")
                        off += h * w
                    raise AssertionError(
                        f"K2 disagrees with the plain version: "
                        f"{name} {dtype} {padding_mode} ac={align_corners}")
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
    ``multiscale_deformable_attention`` in a forward that autograd records,
    where the module runs its chain and the op: without autograd it calls
    K1's prologue variant instead), so that the kernels it runs do not
    matter; the forward stops at that call.  Returns ``(img, shapes, pts,
    wts)``, f32 and contiguous."""
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
        with torch.enable_grad():
            model(pyramid, shapes)
    except _Captured:
        pass
    finally:
        attention.multiscale_deformable_attention = real
    img, pts, wts = (t.detach().float().contiguous().clone()
                     for t in seen[call])
    del model, pyramid, seen
    return img, shapes, pts, wts


def model_queries(hw=IMAGE_HW, batch: int = BATCH, call: int = 0,
                  compute_dtype=None, seed: int = 30):
    """The arguments of K1's prologue variant at its ``call``-th call in
    one inference forward of the full-width two-stage model (0: encoder
    layer 0, 6: decoder layer 0), as ``model_call`` spies the op's: the
    projected pyramid ``img`` [B, I, H, C] and the query projection's
    output ``q`` [B, N, H, L, P, 3], in the model's compute dtype, and the
    reference points as the module passes them (the encoder's [I, 2]
    expanded over the batch).  Returns ``(img, shapes, q, refs)``."""
    shapes = model_shapes(hw)
    model = build_model("cuda", True, compute_dtype)
    pyramid = make_pyramid(seed, shapes, batch)
    seen, real = [], library.msda_fwd_queries

    def spy(img, q, refs, *args):
        if len(seen) == call:
            seen.append((img, q, refs))
            raise _Captured
        seen.append(None)
        return real(img, q, refs, *args)

    library.msda_fwd_queries = spy
    try:
        with torch.inference_mode():
            model(pyramid, shapes)
    except _Captured:
        pass
    finally:
        library.msda_fwd_queries = real
    with torch.inference_mode(False):
        img, q, refs = (t.clone() for t in seen[call])
    del model, pyramid, seen
    if refs.stride(0) == 0:  # keep the encoder's points unmaterialised
        refs = refs[:1].clone().expand(refs.shape)
    return img.contiguous(), shapes, q.contiguous(), refs


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


def forward_launches() -> tuple[int, int]:
    """The launch counters of K1's prologue variant and of K1."""
    return cuda_fwd_queries.LAUNCHES, cuda_fwd.LAUNCHES


def check_inference_forward(before, what: str = "a forward",
                            mesh: bool = False) -> None:
    """Fail unless an inference forward since ``before``
    (``forward_launches()``) launched K1's prologue variant
    LAUNCHES_PER_FORWARD times and K1 none; on a mesh, K1
    LAUNCHES_PER_FORWARD times and the variant none."""
    now = forward_launches()
    launched = (now[0] - before[0], now[1] - before[1])
    want = (0, LAUNCHES_PER_FORWARD) if mesh else (LAUNCHES_PER_FORWARD, 0)
    if launched != want:
        raise AssertionError(
            f"{what} launched (K1's prologue variant, K1) {launched} times, "
            f"expected {want}")


def serve_once(model, pyramid, image_sizes, mesh: bool = False):
    before = forward_launches()
    out = model(pyramid, SLICE_SHAPES)
    det = postprocess(out, top_k=100, scoring="sigmoid",
                      image_sizes=image_sizes)
    check_inference_forward(before, mesh=mesh)
    return out, det


def serving_fn(model):
    """A user's serving function: the forward and ``postprocess`` of a
    request ``(pyramid, image_sizes)``, captured per input signature as a
    CUDA graph (``utils.graphs.graphed``); ``__wrapped__`` is the eager
    request (``postprocess`` runs in a profiler span of its own)."""
    def request(pyramid, image_sizes):
        out = model(pyramid, SLICE_SHAPES)
        return postprocess(out, top_k=100, scoring="sigmoid",
                           image_sizes=image_sizes)

    return graphed(request)


def timed_request(fn, pyramid, image_sizes):
    """One request through ``fn``, timed with CUDA events; it must launch
    K1's prologue variant LAUNCHES_PER_FORWARD times and K1 none (a replay
    counts the captured launches).  Returns ``(detections, ms)``."""
    before = forward_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    det = fn(pyramid, image_sizes)
    end.record()
    torch.cuda.synchronize()
    check_inference_forward(before, "a request")
    return det, start.elapsed_time(end)


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


def check_detections(det, batch: int = BATCH) -> None:
    for k, shape in (("scores", (batch, 100)), ("labels", (batch, 100)),
                     ("boxes", (batch, 100, 4))):
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
    """Phase 4: the main path, a user's graphed serving function
    (``serving_fn``): a warm-up, the capture (and its replay), then 3
    replays, each beside the eager request (``__wrapped__``) in turns.
    Returns every kernel's launch count and the mean request time in ms of
    each dtype, graphed and eager."""
    image_sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
    requests = [make_pyramid(20 + i) for i in range(3)]
    models = {"f32": build_model("auto", True),
              "bf16": build_model("auto", True, torch.bfloat16)}
    torch.cuda.synchronize()

    reset_launches()
    forwards, means, norms = 0, {}, 0
    with torch.inference_mode():
        for name, model in models.items():
            at_start = forwards
            fn = serving_fn(model)
            for _ in range(2):  # the warm-up; the capture and its replay
                check_detections(timed_request(fn, requests[0],
                                               image_sizes)[0])
                forwards += 1
            times = {"graphed": [], "eager": []}
            for i, pyramid in enumerate(requests):
                turns = ("graphed", "eager")[::1 if i % 2 == 0 else -1]
                for mode in turns:
                    det, ms = timed_request(
                        fn if mode == "graphed" else fn.__wrapped__,
                        pyramid, image_sizes)
                    forwards += 1
                    times[mode].append(ms)
                    check_detections(det)
            out, det = serve_once(model, requests[0], image_sizes)
            forwards += 1
            check_outputs(out, det)
            means[name] = {mode: sum(ts) / len(ts)
                           for mode, ts in times.items()}
            log(f"serving {name}: batch {BATCH} at {IMAGE_HW[0]}x"
                f"{IMAGE_HW[1]}, graphed per-request ms "
                f"{', '.join(f'{t:.3f}' for t in times['graphed'])} "
                f"(mean {means[name]['graphed']:.3f}) on {smi}")
            log(f"serving {name} eager (__wrapped__), in turns: per-request "
                f"ms {', '.join(f'{t:.3f}' for t in times['eager'])} (mean "
                f"{means[name]['eager']:.3f}); graphed "
                f"{means[name]['eager'] / means[name]['graphed']:.2f}x "
                f"faster on {smi}")
            del fn
            if name == "bf16":
                norms += (forwards - at_start) * NORMS_PER_HALF_FORWARD
    counts = launches()
    if forwards == 0:
        raise AssertionError("no forward was served")
    # without autograd, every call runs K1's prologue variant and no K1
    check_path_launches("serving", counts, {
        cuda_fwd_queries.KERNEL: forwards * LAUNCHES_PER_FORWARD,
        cuda_norm.KERNEL: norms})
    log(f"serving: {forwards} requests, launches {counts} "
        f"({LAUNCHES_PER_FORWARD} {cuda_fwd_queries.KERNEL} and 0 "
        f"{cuda_fwd.KERNEL} per request, replays included)")
    del models
    torch.cuda.empty_cache()
    return counts, means


# Phase 4b: the graphed request against the eager one.  Both run the same
# kernels on the same inputs, so they are held to phase 8b's bars
# (EXPORT_TOL): labels equal, scores and boxes within tol * max(1, |eager|).
SECOND_SIGNATURE_BATCH = 1


def detection_error(got, want) -> tuple[bool, float]:
    """Whether the labels are equal, and the worst error of the scores and
    boxes relative to max(1, |want|)."""
    return (torch.equal(got["labels"], want["labels"]),
            max(errors(got[k], want[k])[2] for k in ("scores", "boxes")))


def peak_gib(fn, *args):
    """``fn(*args)`` and the peak allocated memory over it, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def graph_serving(smi: str) -> None:
    """Phase 4b: a user's graphed serving function against its eager
    request (``__wrapped__``) on the same inputs, f32 and bf16: the capture's
    replay on request a and a replay on request b, each held to the eager
    request on it (eager against eager printed beside), b's detections
    differing from a's (the replay reads its new inputs); a second
    signature (batch 1) with a capture of its own, held the same way; one
    eager request with host syncs as errors; peak allocated memory, graphed
    against eager."""
    sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
    a, b = make_pyramid(40), make_pyramid(41)
    one = make_pyramid(42, batch=SECOND_SIGNATURE_BATCH)
    one_sizes = sizes[:SECOND_SIGNATURE_BATCH].clone()
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = build_model("auto", True, dtype)
        fn = serving_fn(model)
        eager = fn.__wrapped__
        tol = EXPORT_TOL[name]
        resident_gib = torch.cuda.memory_allocated() / 2**30
        with torch.inference_mode():
            _, warm_gib = peak_gib(fn, a, sizes)  # the warm-up, eager
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager(a, sizes)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log(f"eager {name} request under set_sync_debug_mode('error'), "
                f"image_sizes on the card: no host sync")
            want_a, eager_gib = peak_gib(eager, a, sizes)
            again = eager(a, sizes)
            got_a, capture_gib = peak_gib(fn, a, sizes)  # capture + replay
            got_b, replay_gib = peak_gib(fn, b, sizes)
            want_b = eager(b, sizes)
            fn(one, one_sizes)  # the second signature's warm-up
            got_one, second_gib = peak_gib(fn, one, one_sizes)
            want_one = eager(one, one_sizes)
            held_gib = torch.cuda.memory_allocated() / 2**30
        checks = {"a": detection_error(got_a, want_a),
                  "b": detection_error(got_b, want_b),
                  f"batch {SECOND_SIGNATURE_BATCH}": detection_error(
                      got_one, want_one)}
        noise = detection_error(again, want_a)
        control = detection_error(got_b, got_a)
        for det, batch in ((got_a, BATCH), (got_b, BATCH),
                           (got_one, SECOND_SIGNATURE_BATCH)):
            check_detections(det, batch)
        ok = all(same and err <= tol for same, err in checks.values())
        differs = not control[0] or control[1] > tol
        log(f"graphed {name} request against eager (labels equal, scores/"
            f"boxes err, tol {tol:g}): " + "; ".join(
                f"{k} {'equal' if same else 'DIFFER'} {err:.3e}"
                for k, (same, err) in checks.items())
            + f"; eager against eager {'equal' if noise[0] else 'DIFFER'} "
            f"{noise[1]:.3e}; control, the replay on b against the capture "
            f"on a: labels {'equal' if control[0] else 'differ'}, "
            f"{control[1]:.3e} {'ok' if ok and differs else 'FAIL'}")
        log(f"peak allocated {name}, GiB (the model and inputs resident: "
            f"{resident_gib:.3f}): warm-up (eager) {warm_gib:.3f}, "
            f"eager request {eager_gib:.3f}, capture + replay "
            f"{capture_gib:.3f}, replay {replay_gib:.3f}, second signature's "
            f"capture + replay {second_gib:.3f}; allocated with both graphs "
            f"held {held_gib:.3f}, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.3f} on {smi}")
        if not ok:
            raise AssertionError(f"graphed {name} request: detections differ "
                                 "from the eager request's")
        if not differs:
            raise AssertionError(f"graphed {name} request: the replay on "
                                 "request b returned request a's detections")
        del model, fn, eager
        torch.cuda.empty_cache()


# Phase 4c: one graphed serving function over the input sizes of Deformable
# DETR's evaluation resize (its public repository's datasets/coco.py,
# make_coco_transforms: shorter side 800, longer side at most 1333, so the
# batch's shape follows the aspect ratio), batch 2.
EVAL_SIZES = ((800, 1333), (800, 1067), (800, 1200), (800, 800),
              (750, 1333), (1333, 800), (1067, 800), (1200, 800))
SHAPES_BOUND = 4  # max_signatures of 4c's bounded run
# the bounded run's order: the first four sizes in three rounds (warm-ups,
# captures, replays), the last four likewise (each warm-up drops one of
# the first four), then the first four in two rounds (each a warm-up and a
# capture again)
BOUNDED_ORDER = (EVAL_SIZES[:4] * 3 + EVAL_SIZES[4:] * 3 + EVAL_SIZES[:4] * 2)
BOUNDED_CAPTURES = 12


def device_pyramid(seed: int, hw, batch: int = BATCH):
    """A seeded pyramid for an input of ``hw`` pixels (``model_shapes``),
    drawn on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn((batch, h, w, c), generator=g, device=DEVICE)
            for (h, w), c in zip(model_shapes(hw), IN_CHANNELS)]


def image_sizes(hw, batch: int = BATCH):
    return torch.tensor([hw] * batch, device=DEVICE)


def shapes_serving_fn(model, **kw):
    """A user's serving function for every input size: the forward (its
    level shapes those of the pyramid's tensors) and ``postprocess``,
    graphed (``utils.graphs.graphed(..., **kw)``)."""
    def request(pyramid, sizes):
        shapes = tuple(tuple(level.shape[1:3]) for level in pyramid)
        return postprocess(model(pyramid, shapes), top_k=100,
                           scoring="sigmoid", image_sizes=sizes)

    return graphed(request, **kw)


@contextlib.contextmanager
def counted_captures():
    """Count the captures of every graphed function (``graphs._capture``)
    while the block runs; yields a one-element list, the count."""
    real, count = graphs_module._capture, [0]

    def counting(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    graphs_module._capture = counting
    try:
        yield count
    finally:
        graphs_module._capture = real


def memory_now() -> tuple[int, int]:
    """Reserved and allocated bytes once the allocator's unused cached
    blocks are released: what the live tensors and graphs hold."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def growth_gib(before, after) -> tuple[float, float]:
    return tuple((a - b) / 2**30 for a, b in zip(after, before))


def held_request(fn, eager, pyramid, sizes, tol,
                 what) -> tuple[dict, float]:
    """One request through ``fn`` held to the eager request on the same
    inputs (phase 4b's bars); returns ``fn``'s detections and their
    error."""
    got = timed_request(fn, pyramid, sizes)[0]
    want = timed_request(eager, pyramid, sizes)[0]
    check_detections(got)
    same, err = detection_error(got, want)
    if not same or err > tol:
        raise AssertionError(f"{what}: detections differ from the eager "
                             f"request's (labels {'equal' if same else 'differ'},"
                             f" err {err:.3e}, tol {tol:g})")
    return got, err


def serve_shapes(smi: str, live_ms: dict | None = None) -> dict:
    """Phase 4c: one graphed serving function over the eight evaluation
    sizes, f32 and bf16: each size's warm-up and capture (one pool), two
    round-robin passes of replays on new seeded inputs, each held to the
    eager request and to differ from its size's previous replay, and three
    timed replays at 800x1333 beside phase 4's mean (``live_ms``, by
    dtype, when phase 4 ran); the reserved and
    allocated growth beside eight separate graphed functions (one pool
    each, the control); in f32 a run with max_signatures=4.  Returns every
    kernel's launches."""
    reset_launches()
    requests = norms = 0
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = build_model("auto", True, dtype)
        tol = EXPORT_TOL[name]
        at_start = requests
        with torch.inference_mode():
            base = memory_now()
            fn = shapes_serving_fn(model)
            with counted_captures() as captures:
                for i, hw in enumerate(EVAL_SIZES):
                    pyramid = device_pyramid(100 + i, hw)
                    for _ in range(2):  # the warm-up; the capture + replay
                        check_detections(timed_request(
                            fn, pyramid, image_sizes(hw))[0])
                        requests += 1
                    del pyramid
                shared = growth_gib(base, memory_now())
                worst, previous = 0.0, {}
                for turn in range(2):
                    for i, hw in enumerate(EVAL_SIZES):
                        pyramid = device_pyramid(200 + 10 * turn + i, hw)
                        got, err = held_request(
                            fn, fn.__wrapped__, pyramid, image_sizes(hw),
                            tol, f"4c {name} {hw} pass {turn}")
                        requests += 2
                        worst = max(worst, err)
                        if hw in previous:
                            same, err = detection_error(got, previous[hw])
                            if same and err <= tol:
                                raise AssertionError(
                                    f"4c {name} {hw}: the replay returned "
                                    "the previous input's detections")
                        previous[hw] = got
                        del pyramid
                pyramid = device_pyramid(300, IMAGE_HW)
                ms = [timed_request(fn, pyramid, image_sizes(IMAGE_HW))[1]
                      for _ in range(3)]
                requests += 3
            if captures[0] != len(EVAL_SIZES) or fn.cache_size() != len(
                    EVAL_SIZES):
                raise AssertionError(f"4c {name}: {captures[0]} captures, "
                                     f"{fn.cache_size()} signatures kept; "
                                     f"expected {len(EVAL_SIZES)} of each")
            mean = sum(ms) / len(ms)
            log(f"4c {name}: one graphed function over {len(EVAL_SIZES)} "
                f"sizes, {captures[0]} captures; 2 passes of replays held "
                f"to the eager request (labels equal, worst scores/boxes "
                f"err {worst:.3e}, tol {tol:g}), each differing from its "
                f"size's previous replay; graphed ms at {IMAGE_HW[0]}x"
                f"{IMAGE_HW[1]} {', '.join(f'{t:.3f}' for t in ms)} (mean "
                f"{mean:.3f}" + (f"; phase 4: {live_ms[name]:.3f}"
                                   if live_ms else "") + f") on {smi}")
            del fn, pyramid, previous, got

            base = memory_now()  # the control: a graphed function a size
            control, each = [], []
            for i, hw in enumerate(EVAL_SIZES):
                control.append(shapes_serving_fn(model))
                pyramid = device_pyramid(100 + i, hw)
                for _ in range(2):
                    check_detections(timed_request(
                        control[-1], pyramid, image_sizes(hw))[0])
                    requests += 1
                del pyramid
                each.append(memory_now()[0])
            separate = growth_gib(base, memory_now())
            del control
            memory_now()
            each = [(b - a) / 2**30 for a, b in zip([base[0]] + each, each)]
            log(f"4c {name} memory over {len(EVAL_SIZES)} signatures, GiB "
                f"grown (reserved, allocated): one function, one pool "
                f"{shared[0]:.3f}, {shared[1]:.3f}; {len(EVAL_SIZES)} "
                f"functions, a pool each {separate[0]:.3f}, "
                f"{separate[1]:.3f} (reserved by size: "
                f"{', '.join(f'{g:.3f}' for g in each)}); reserved "
                f"{shared[0] / separate[0]:.2f}x the control on {smi}")
            if name == "f32" and shared[0] > separate[0] / 2:
                raise AssertionError(f"4c f32: one pool grew reserved "
                                     f"{shared[0]:.3f} GiB, more than half "
                                     f"of the control's {separate[0]:.3f}")

            if name == "f32":  # the bounded run
                fn = shapes_serving_fn(model, max_signatures=SHAPES_BOUND)
                kept = 0
                with counted_captures() as captures:
                    for i, hw in enumerate(BOUNDED_ORDER):
                        pyramid = device_pyramid(400 + i, hw)
                        held_request(fn, fn.__wrapped__, pyramid,
                                     image_sizes(hw), tol,
                                     f"4c bounded call {i} {hw}")
                        requests += 2
                        kept = max(kept, fn.cache_size())
                        del pyramid
                if kept > SHAPES_BOUND or captures[0] != BOUNDED_CAPTURES:
                    raise AssertionError(
                        f"4c bounded: {kept} signatures kept (at most "
                        f"{SHAPES_BOUND}), {captures[0]} captures "
                        f"(expected {BOUNDED_CAPTURES})")
                log(f"4c f32 with max_signatures={SHAPES_BOUND}: "
                    f"{len(BOUNDED_ORDER)} calls over {len(EVAL_SIZES)} "
                    f"sizes, every one held to the eager request; at most "
                    f"{kept} signatures kept, {captures[0]} captures (a "
                    f"dropped size warms up and captures again)")
                del fn
        if dtype is not None:
            norms += (requests - at_start) * NORMS_PER_HALF_FORWARD
        del model
        memory_now()
    counts = launches()
    check_path_launches("serving over shapes", counts, {
        cuda_fwd_queries.KERNEL: requests * LAUNCHES_PER_FORWARD,
        cuda_norm.KERNEL: norms})
    log(f"4c: {requests} requests, launches {counts}")
    return counts


def adamw(model):
    """The Deformable DETR optimizer, capturable (the graphed step)."""
    return torch.optim.AdamW(model.parameters(), lr=2e-4, weight_decay=1e-4,
                             capturable=True)


def train(smi: str) -> tuple[dict, dict]:
    """Phase 5: the main path of the backward, through the graphed step
    (the first call a warm-up, the second the capture and its replay).
    Returns every kernel's launches over the training run and in one f32
    step (no remat)."""
    pyramid, targets = make_pyramid(30), make_targets(31)
    reset_launches()
    steps, per_step = 0, {}
    expected = {cuda_fwd.KERNEL: 0, cuda_bwd.KERNEL: 0,
                cuda_matcher.KERNEL: 0}
    runs = (("f32", None, False, 1 + TRAIN_STEPS),
            ("bf16", torch.bfloat16, False, 1 + TRAIN_STEPS),
            ("f32 remat", None, True, 3))
    for name, compute_dtype, remat, n_steps in runs:
        model = build_model("auto", True, compute_dtype, remat).train()
        optimizer = adamw(model)
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
            launched = (counts[cuda_fwd.KERNEL], counts[cuda_bwd.KERNEL],
                        counts[cuda_matcher.KERNEL])
            if name == "f32":
                per_step = counts
            losses.append(loss.item())
            times.append(start.elapsed_time(end))
            want = (k1_per_step, LAUNCHES_PER_FORWARD, AUCTIONS_PER_STEP)
            for kernel, n in zip(expected, want):
                expected[kernel] += n
            what = ("warm-up", "capture + replay")[i] if i < 2 else "replay"
            log(f"train {name} step {i} ({what}): loss {losses[-1]:.6f} "
                f"matcher_converged {bool(metrics['matcher_converged'])} "
                f"{times[-1]:.3f} ms, K1 {launched[0]} K2 {launched[1]} "
                f"auction {launched[2]} launches")
            if launched != want:
                raise AssertionError(
                    f"a {name} training step launched (K1, K2, auction) "
                    f"{launched}, expected {want}")
            if not np.isfinite(losses[-1]):
                raise AssertionError(f"{name}: loss is not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        timed = times[2:]  # the replays
        log(f"train {name}: batch {BATCH} at {IMAGE_HW[0]}x{IMAGE_HW[1]}, "
            f"mean step {sum(timed) / len(timed):.3f} ms over "
            f"{len(timed)} replayed "
            f"step(s), peak allocated {peak:.3f} GiB on {smi}")
        if n_steps == 1 + TRAIN_STEPS and not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall on a "
                                 f"repeated batch: {losses}")
        for p in model.parameters():
            if not torch.isfinite(p).all():
                raise AssertionError(f"{name}: a parameter is not finite")
        del model, optimizer, step
    counts = launches()
    # unforced, every call runs K1/K2 in f32 and bf16 (stream.FORCE)
    check_path_launches("training", counts, expected)
    log(f"training: {steps} steps, launches {counts}; per f32 step "
        f"{per_step}")
    return counts, per_step


# Phase 5b: the auction kernel against its plain version, and the train
# step captured as a CUDA graph against the eager step.
AUCTION_EPS = 1e-3  # the matcher's default bid increment
# the graphed step's loss against the eager step's from the same parameters,
# relative: the same forward (bf16: its usual half-type bar)
GRAPH_LOSS_TOL = {"f32": 1e-5, "bf16": 1e-2}
# every parameter after an f32 SGD step, graphed against eager from the same
# parameters, of the floored scale (parameter_error): phase 9b's bar, since
# only K2's f32 atomics differ
GRAPH_PARAM_TOL = 1e-6
# a step's update, graphed against the eager step's from the same parameters
# and optimizer state, over all parameters (update_error).  Two eager steps
# from one state part by K2's run-dependent atomics, under 1e-5 in f32 and
# 4e-3 in bf16; a step that updates nothing reads 1, the other batch's step
# 0.5-0.9 (NVIDIA H100 80GB HBM3; both are printed beside each reading)
GRAPH_UPDATE_TOL = {"f32": 1e-3, "bf16": 0.1}
# The losses of a warm-up and 5 AdamW steps run freely, graphed against
# eager, are held only after the first update (to GRAPH_LOSS_TOL), then to
# being finite and falling: the runs part by K2's run-dependent atomics,
# which AdamW turns into full-size updates, and two eager runs part by
# 4e-5 to 6e-3 (f32) and 5e-2 (bf16) after 5 steps (NVIDIA H100 80GB
# HBM3).  Each replay's step is held above, from the graphed run's state.
GRAPH_LR = 2e-4  # SGD, as phase 9b
TURN_STEPS = 5  # steps a turn when eager and graphed steps are timed
# the kernels of a step in a trace: (launch counter, name in the trace)
TRACED = ((cuda_fwd.KERNEL, "msda_fwd_kernel"),
          (cuda_bwd.KERNEL, "msda_bwd_kernel"),
          (cuda_matcher.KERNEL, "msda_auction_kernel"))


def snapshot(model) -> dict:
    """A copy of ``model``'s parameters, by name."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


def parameter_error(got: dict, want: dict) -> tuple[float, str, float]:
    """The worst difference between two models' parameters (by name, in
    the models' order): over each tensor's largest value, at least
    GRAD_FLOOR of the model's largest (a tensor that starts at zero, like
    the MSDA query projections' weights, holds lr x its gradient after a
    step, whose last bits K2's atomic order sets).  Returns ``(worst, its
    parameter, worst over the tensor's largest alone)``."""
    floor = GRAD_FLOOR * max(q.abs().max().item() for q in want.values())
    worst, worst_name, strict = -1.0, "", 0.0
    for (name, p), q in zip(got.items(), want.values()):
        diff = (p - q).abs().max().item()
        largest = q.abs().max().item()
        strict = max(strict, diff / largest if largest else diff)
        err = diff / max(largest, floor)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, strict


def update_error(got: dict, want: dict, before: dict) -> tuple[float, str]:
    """Two steps' updates from the same parameters ``before``: |got - want|
    over |want - before|, each the 2-norm over every parameter (so a step
    that updates nothing reads 1).  Returns it and the parameter that holds
    the most of |got - want|."""
    num = den = 0.0
    worst, worst_name = -1.0, ""
    for (name, p), q, b in zip(got.items(), want.values(), before.values()):
        diff = (p.float() - q.float()).square().sum().item()
        num += diff
        den += (q.float() - b.float()).square().sum().item()
        if diff > worst:
            worst, worst_name = diff, name
    return (num / den) ** 0.5, worst_name


def load_state(model, optimizer, source, source_optimizer) -> None:
    """Give ``model`` and ``optimizer`` copies of ``source``'s parameters
    and of ``source_optimizer``'s state."""
    model.load_state_dict(source.state_dict())
    optimizer.load_state_dict(copy.deepcopy(source_optimizer.state_dict()))


def compare_step(what, gstep, graphed, gopt, estep, eager, eopt, batch,
                 other=None, param_tol=None) -> tuple[float, dict]:
    """One call of the graphed step ``gstep`` (of ``graphed`` and ``gopt``)
    on ``batch``, held to the eager step ``estep`` (of ``eager`` and
    ``eopt``) from copies of the same parameters and optimizer state: the
    loss within GRAPH_LOSS_TOL, the update within GRAPH_UPDATE_TOL, and with
    ``param_tol`` every parameter (parameter_error).  Beside it, a second
    eager step from the same state (the noise), and the controls that the
    update bar must reject: no update, and with ``other`` (a batch) the
    eager step on it.  Returns the graphed loss and the readings."""
    name = "f32" if "f32" in what else "bf16"
    before = snapshot(graphed)
    eager_runs = []
    for run in [batch, batch] + ([other] if other is not None else []):
        load_state(eager, eopt, graphed, gopt)
        loss = estep(*run)[0].item()
        eager_runs.append((loss, snapshot(eager)))
    gloss = gstep(*batch)[0].item()
    got = snapshot(graphed)
    (eloss, want), (_, again) = eager_runs[:2]
    got_err, got_name = update_error(got, want, before)
    readings = {
        "loss_rel": abs(gloss - eloss) / abs(eloss),
        "update": got_err,
        "update_eager_again": update_error(again, want, before)[0],
        "control_no_update": update_error(before, want, before)[0],
    }
    if other is not None:
        readings["control_other_batch"] = update_error(
            eager_runs[2][1], want, before)[0]
    worst, worst_name, strict = parameter_error(got, want)
    readings["params"] = worst
    ok = (readings["loss_rel"] <= GRAPH_LOSS_TOL[name]
          and got_err <= GRAPH_UPDATE_TOL[name]
          and (param_tol is None or worst <= param_tol))
    controls = [v for k, v in readings.items() if k.startswith("control")]
    log(f"graphed {what}: loss {gloss:.6f}, eager {eloss:.6f} (rel "
        f"{readings['loss_rel']:.2e}, tol {GRAPH_LOSS_TOL[name]:g}); update "
        f"{got_err:.2e} of the eager update ({got_name}; tol "
        f"{GRAPH_UPDATE_TOL[name]:g}); eager again "
        f"{readings['update_eager_again']:.2e}; controls "
        + ", ".join(f"{k[8:]} {v:.3f}" for k, v in readings.items()
                    if k.startswith("control"))
        + f"; parameters worst {worst:.2e} of the floored scale ({worst_name}"
        f"{f'; tol {param_tol:g}' if param_tol is not None else ''}; "
        f"{strict:.2e} of the tensor's largest alone) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"graphed {what}: the step differs from the "
                             "eager step")
    if min(controls) <= GRAPH_UPDATE_TOL[name]:
        raise AssertionError(f"graphed {what}: a control passes the update "
                             "bar, which then cannot see a wrong update")
    return gloss, readings


def auction_cases(step_costs) -> list:
    """Phase 5b's auction cases: ``(name, cost [B, N, M] f32, active
    [B, M] bool or None, max_rounds)`` on the card."""
    rng = np.random.default_rng(50)
    cases = [(f"step head {i} {tuple(cost.shape)}", cost, active, 2000)
             for i, (cost, active) in enumerate(step_costs)]
    for shape in ((2, 300, 50), (16, 300, 50), (2, 900, 300)):
        B, _, M = shape
        uniform = rng.random(shape, dtype=np.float32)
        mask = np.zeros((B, M), bool)
        for b in range(B):
            mask[b, :rng.integers(5, 10)] = True  # as phase 5's targets
        for kind, cost, active in (
                ("uniform", uniform, None),
                ("ties", np.floor(uniform * 4), None),  # 4 cost values
                ("constant", np.full(shape, 0.5, np.float32), None),
                # masked-out slots cost 0 everywhere, as in detection_loss
                ("masked", np.where(mask[:, None, :], uniform, 0), mask)):
            cases.append((f"{kind} {shape}", cost, active, 2000))
    square = rng.random((2, 64, 64), dtype=np.float32)
    for rounds in (2000, 1, 3, 17):
        cases.append((f"square (2, 64, 64), max_rounds {rounds}", square,
                      None, rounds))
    return [(name, torch.as_tensor(cost, dtype=torch.float32,
                                   device=DEVICE).contiguous(),
             None if active is None else torch.as_tensor(active,
                                                         device=DEVICE),
             rounds) for name, cost, active, rounds in cases]


def auction_costs_in_shared(N: int, M: int) -> bool:
    """Whether the auction kernel keeps an image's N x M costs in shared
    memory, as its launch decides: when they fit beside its per-query and
    per-target state (16 bytes each) in a block's opt-in shared memory, an
    SM's less the 1 KB that the runtime reserves for a block."""
    props = torch.cuda.get_device_properties(DEVICE)
    limit = props.shared_memory_per_multiprocessor - 1024
    return 16 * (N + M) + 4 * N * M <= limit


def check_auction(smi: str, step_costs) -> dict:
    """Phase 5b a: the auction kernel against ``plain_auction`` in every
    case, indices and flags equal; each case timed beside the plain loop.
    Returns the JSON row's numbers, from the step's first head."""
    worst, budgets_short, row = 0, 0, None
    for name, cost, active, rounds in auction_cases(step_costs):
        q, conv, taken = cuda_matcher.auction(cost, active, AUCTION_EPS,
                                              rounds)
        want_q, want_conv = plain_auction(cost, active, AUCTION_EPS, rounds)
        err = (q - want_q).abs().max().item()
        same = torch.equal(q, want_q) and torch.equal(conv, want_conv)
        ms = time_ms(lambda: cuda_matcher.auction(  # noqa: B023
            cost, active, AUCTION_EPS, rounds), 20)
        plain_ms = time_ms(lambda: plain_auction(  # noqa: B023
            cost, active, AUCTION_EPS, rounds), 2)
        taken = taken.tolist()
        B, N, M = cost.shape
        where = "shared" if auction_costs_in_shared(N, M) else "L2"
        log(f"auction {name}: {'equal' if same else 'DIFFER'}, converged "
            f"{sum(conv.tolist())}/{B}, rounds {min(taken)}-{max(taken)}, "
            f"costs in {where}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms"
            f" on {smi}")
        if not same:
            raise AssertionError(f"auction {name}: the kernel's query_idx or "
                                 "converged differ from the plain loop's")
        worst = max(worst, err)
        budgets_short += "max_rounds" in name and not conv.all().item()
        if row is None:  # the step's first head: the main path's call
            nbytes = B * N * M * 4  # each cost read once
            row = {"ms": ms, "plain_ms": plain_ms,
                   "bound": dict(zip(("ms", "bound_by"),
                                     roofline_ms(nbytes, 0.0)))}
    if not budgets_short:
        raise AssertionError("no round budget left the auction unconverged: "
                             "the fallback went untested")
    log(f"auction: every case equal to the plain loop; the step's call "
        f"{row['ms']:.4f} ms (plain {row['plain_ms']:.3f} ms, bound "
        f"{row['bound']['ms']:.3e} ms by {row['bound']['bound_by']}; bound "
        f"by latency: rounds x one round)")
    return {**row, "err": float(worst)}


def step_time(step, pyramid, targets) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    step(pyramid, targets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def graph_vs_eager(name, dtype, batches, smi, step_costs):
    """Phase 5b b-e for one dtype: the graphed step against the eager one
    (SGD on two batches, then 5 AdamW steps), in f32 one replay under the
    profiler, and both steps timed in turns.  ``batches`` holds two
    ``(pyramid, targets)`` of the same shapes; the runs use the first.
    Appends the step's auction costs to ``step_costs`` (f32).  Returns
    ``(times, profile, readings)``."""
    pyramid, targets = batches[0]
    graphed = build_model("auto", True, dtype).train()
    eager = build_model("auto", True, dtype).train()
    init = {k: v.clone() for k, v in graphed.state_dict().items()}
    kw = dict(return_metrics=True, **LOSS_KW)
    readings = {}

    # c. SGD: the graphed step's warm-up runs at lr 0, which leaves the
    # parameters as they are; then its capture and replay on batch a, and a
    # replay on batch b (its inputs copied in), each held to the eager step
    # on that batch from the same parameters, and to the other batch's
    # step as a control
    sgd = torch.optim.SGD(graphed.parameters(), lr=0.0)
    gstep = make_train_step(graphed, sgd, SLICE_SHAPES, **kw)
    gstep(pyramid, targets)
    sgd.param_groups[0]["lr"] = GRAPH_LR
    esgd = torch.optim.SGD(eager.parameters(), lr=GRAPH_LR)
    estep = make_train_step(eager, esgd, SLICE_SHAPES, **kw).__wrapped__
    for label, batch, other in (("a", batches[0], batches[1]),
                                ("b", batches[1], batches[0])):
        readings[f"sgd {label}"] = compare_step(
            f"{name} SGD step (lr {GRAPH_LR:g}) on batch {label}", gstep,
            graphed, sgd, estep, eager, esgd, batch, other,
            GRAPH_PARAM_TOL if dtype is None else None)[1]
    del gstep, estep, sgd, esgd
    if dtype is None:  # the remat step: its capture's replay on batch a
        rgraphed, reager = (build_model("auto", True, None, remat=True)
                            .train() for _ in range(2))
        rgraphed.load_state_dict(init)
        sgd = torch.optim.SGD(rgraphed.parameters(), lr=0.0)
        gstep = make_train_step(rgraphed, sgd, SLICE_SHAPES, **kw)
        gstep(pyramid, targets)
        sgd.param_groups[0]["lr"] = GRAPH_LR
        esgd = torch.optim.SGD(reager.parameters(), lr=GRAPH_LR)
        estep = make_train_step(reager, esgd, SLICE_SHAPES,
                                **kw).__wrapped__
        readings["remat sgd a"] = compare_step(
            f"{name} remat SGD step (lr {GRAPH_LR:g}) on batch a", gstep,
            rgraphed, sgd, estep, reager, esgd, batches[0], batches[1],
            GRAPH_PARAM_TOL)[1]
        del rgraphed, reager, gstep, estep, sgd, esgd

    # b., c. a warm-up and 5 AdamW steps from the same start, graphed and
    # eager, and eager once more (how far two eager runs part), each run's
    # peak memory beside it; the first eager step under the sync debug
    # mode (no host sync allowed), its auction costs kept for 5b a.  Then
    # 5 more replays of the graphed run, each held to the eager step from
    # its own parameters and optimizer state (compare_step, on the eager
    # model, which the eager runs then reset).
    losses = {}
    for mode, model in (("graphed", graphed), ("eager", eager),
                        ("eager again", eager)):
        model.load_state_dict(init)
        optimizer = adamw(model)
        step = make_train_step(model, optimizer, SLICE_SHAPES, **kw)
        if mode != "graphed":
            step = step.__wrapped__
        torch.cuda.reset_peak_memory_stats()
        losses[mode] = []
        for i in range(1 + TRAIN_STEPS):
            if mode == "eager" and i == 0:
                loss = sync_free_step(step, pyramid, targets,
                                      step_costs if dtype is None else None)
            else:
                loss = step(pyramid, targets)[0]
            losses[mode].append(loss.item())
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{mode} {name} AdamW: losses "
            f"{', '.join(f'{v:.6f}' for v in losses[mode])}; peak allocated "
            f"{peak:.3f} GiB over the run on {smi}")
        if mode == "graphed":
            gstep = step
            eopt = adamw(eager)
            forced = make_train_step(eager, eopt, SLICE_SHAPES,
                                     **kw).__wrapped__
            for i in range(1 + TRAIN_STEPS, 1 + 2 * TRAIN_STEPS):
                readings[f"adamw {i}"] = compare_step(
                    f"{name} AdamW replay {i}", gstep, graphed, optimizer,
                    forced, eager, eopt, (pyramid, targets))[1]
            del forced, eopt
        else:
            estep = step

    def worst_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    held, tol = slice(1, 2), GRAPH_LOSS_TOL[name]
    rel = worst_rel(losses["graphed"][held], losses["eager"][held])
    ok = rel <= tol and all(
        np.isfinite(v).all() and v[-1] < v[0] for v in losses.values())
    log(f"graphed {name} AdamW against eager: worst loss rel "
        f"{worst_rel(losses['graphed'], losses['eager']):.2e}, "
        f"{rel:.2e} on the losses held (tol {tol:g}); eager against eager "
        f"{worst_rel(losses['eager again'], losses['eager']):.2e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"graphed {name}: AdamW losses not finite, not "
                             "falling, or not the eager run's")

    profile = None
    if dtype is None:  # d. one replay under the profiler
        before = launches()
        with trace(os.path.join(TRACE_DIR, "train_f32_graphed")) as t:
            gstep(pyramid, targets)
        counted = {k: launches()[k] - before[k] for k, _ in TRACED}
        names = t.kernel_counts()
        traced = {k: sum(n for kname, n in names.items() if pattern in kname)
                  for k, pattern in TRACED}
        want = dict(zip(counted, (LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD,
                                  AUCTIONS_PER_STEP)))
        busy = t.busy_ms()
        profile = (t.window_ms, busy, t.idle_share())
        log(f"profile graphed f32 replay: window {t.window_ms:.3f} ms, busy "
            f"{busy:.3f} ms, idle {100 * t.idle_share():.1f}%; launches in "
            f"the trace {traced}, counted {counted} on {smi} "
            f"({os.path.relpath(t.path, ROOT)})")
        kernel_ms = t.kernel_ms()
        for kname, ms in list(kernel_ms.items())[:5]:
            log(f"  {ms:9.3f} ms  {kname[:110]}")
        auction_ms = sum(ms for kname, ms in kernel_ms.items()
                         if "msda_auction_kernel" in kname)
        log(f"  the auction kernel: {auction_ms:.4f} ms of device time in "
            f"{AUCTIONS_PER_STEP} launches")
        if traced != want or counted != want:
            raise AssertionError(f"a replay launched {traced} (trace), "
                                 f"{counted} (counters); expected {want}")

    # e. eager and graphed in turns
    times = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        step = estep if mode == "eager" else gstep
        times[mode] += [step_time(step, pyramid, targets)
                        for _ in range(TURN_STEPS)]
    med = {mode: float(np.median(ts)) for mode, ts in times.items()}
    log(f"step time {name}, in turns of {TURN_STEPS}: eager median "
        f"{med['eager']:.3f} ms ({min(times['eager']):.3f}-"
        f"{max(times['eager']):.3f}), graphed median {med['graphed']:.3f} ms "
        f"({min(times['graphed']):.3f}-{max(times['graphed']):.3f}), "
        f"{med['eager'] / med['graphed']:.2f}x on {smi}")
    del graphed, eager, gstep, estep
    torch.cuda.empty_cache()
    return med, profile, readings


def sync_free_step(step, pyramid, targets, costs):
    """One eager step with host syncs as errors; with ``costs`` a list,
    append the (cost, active) of each auction call to it."""
    real = train_module.auction_assignment

    def spy(cost, mask, **kw):
        costs.append((cost.detach().float().contiguous().clone(),
                      mask.to(torch.bool).contiguous().clone()))
        return real(cost, mask, **kw)

    if costs is not None:
        train_module.auction_assignment = spy
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = step(pyramid, targets)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        train_module.auction_assignment = real
    log("eager step under set_sync_debug_mode('error'): no host sync")
    return loss


def graph_path(smi: str) -> dict:
    """Phase 5b: the graphed step against the eager one in f32 and bf16,
    then the auction kernel against its plain version (with the costs of
    one f32 step).  Returns the auction kernel's JSON numbers, the step
    times by dtype and mode, and the graphed f32 replay's profile."""
    batches = [(make_pyramid(30), make_targets(31)),
               (make_pyramid(32), make_targets(33))]
    step_costs, times, profile, readings = [], {}, None, {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        times[name], got, readings[name] = graph_vs_eager(
            name, dtype, batches, smi, step_costs)
        profile = profile or got
    if len(step_costs) != AUCTIONS_PER_STEP:
        raise AssertionError(f"a step called the matcher {len(step_costs)} "
                             f"times, expected {AUCTIONS_PER_STEP}")
    return {"auction": check_auction(smi, step_costs), "times": times,
            "profile": profile, "readings": readings}


# Phase 5c: one graphed step over three input sizes of Deformable DETR's
# training resize (datasets/coco.py: shorter side 480-800 in steps of 32,
# longer side at most 1333), with a learning-rate warm-up stepped every call
TRAIN_SIZES = ((480, 800), (640, 1067), (800, 1333))
SHAPE_ROUNDS = 3  # A B C rounds: warm-ups, captures, replays
SCHEDULE_LR = 2e-4  # AdamW, as phase 5
SCHEDULE_WARMUP = 20  # LambdaLR's linear warm-up: the lr changes every call


def synced(fn) -> int:
    """Run ``fn`` with host syncs reported (``set_sync_debug_mode("warn")``)
    and return how many it made."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def train_shapes(smi: str) -> dict:
    """Phase 5c: the full-width two-stage model's graphed step, f32, over
    three training sizes called in turns (A B C, three rounds: warm-ups,
    captures, replays), AdamW with a tensor lr under a per-step warm-up:
    one capture a size; every call held to an eager step from copies of
    the same parameters and optimizer state, lr included (phase 5b c's
    bars, ``compare_step``); the host syncs of ``scheduler.step()``; the
    reserved growth over the captures beside three separate steps, one
    pool each (the control).  Returns every kernel's launches."""
    reset_launches()
    batches = [(device_pyramid(60 + i, hw), make_targets(70 + i))
               for i, hw in enumerate(TRAIN_SIZES)]
    graphed_model = build_model("auto", True).train()
    eager = build_model("auto", True).train()
    # AdamW with a tensor lr on the card under a linear warm-up, and one
    # step for every size (img_shapes=None)
    optimizer = torch.optim.AdamW(
        graphed_model.parameters(),
        lr=torch.tensor(SCHEDULE_LR, device=DEVICE), weight_decay=1e-4,
        capturable=True)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: min(1.0, (k + 1) / SCHEDULE_WARMUP))
    step = make_train_step(graphed_model, optimizer, None,
                           return_metrics=True, **LOSS_KW)
    eopt = adamw(eager)
    estep = make_train_step(eager, eopt, None, return_metrics=True,
                            **LOSS_KW).__wrapped__
    steps, syncs, worst = 0, 0, 0.0
    with counted_captures() as captures:
        for turn in range(SHAPE_ROUNDS):
            if turn == 1:
                base = memory_now()
            for i, hw in enumerate(TRAIN_SIZES):
                lr = optimizer.param_groups[0]["lr"].item()
                _, readings = compare_step(
                    f"f32 scheduled AdamW (lr {lr:.4e}) at {hw[0]}x{hw[1]}"
                    f", round {turn}", step, graphed_model, optimizer, estep,
                    eager, eopt, batches[i], batches[(i + 1) % 3])
                steps += 4  # the graphed call, eager twice, the control
                worst = max(worst, readings["update"])
                syncs += synced(scheduler.step)
            if turn == 1:
                shared = growth_gib(base, memory_now())
    if captures[0] != len(TRAIN_SIZES):
        raise AssertionError(f"5c: {captures[0]} captures over "
                             f"{SHAPE_ROUNDS} rounds of {len(TRAIN_SIZES)} "
                             f"sizes, expected one a size")
    log(f"5c: one graphed step over {len(TRAIN_SIZES)} sizes "
        f"{list(TRAIN_SIZES)}, {SHAPE_ROUNDS} rounds: {captures[0]} "
        f"captures; every call within the bars of an eager step from the "
        f"same state (worst update {worst:.2e}); scheduler.step() made "
        f"{syncs} host syncs in {SHAPE_ROUNDS * len(TRAIN_SIZES)} steps "
        f"(set_sync_debug_mode('warn')); lr now "
        f"{optimizer.param_groups[0]['lr'].item():.4e} on {smi}")
    del step, estep, eopt, eager
    optimizer.zero_grad(set_to_none=True)
    memory_now()

    # the control: a step a size, one pool each, on the same model and
    # optimizer
    separate = [make_train_step(graphed_model, optimizer, None,
                                return_metrics=True, **LOSS_KW)
                for _ in TRAIN_SIZES]
    for fn, batch in zip(separate, batches):
        fn(*batch)  # the warm-ups
    base = memory_now()
    each = []
    for fn, batch in zip(separate, batches):
        fn(*batch)  # the captures
        each.append(memory_now()[0])
    control = growth_gib(base, memory_now())
    steps += 2 * len(TRAIN_SIZES)
    each = [(b - a) / 2**30 for a, b in zip([base[0]] + each, each)]
    log(f"5c memory over {len(TRAIN_SIZES)} captured sizes, GiB grown "
        f"(reserved, allocated): one step, one pool {shared[0]:.3f}, "
        f"{shared[1]:.3f}; a step a size {control[0]:.3f}, "
        f"{control[1]:.3f} (reserved by size: "
        f"{', '.join(f'{g:.3f}' for g in each)}); reserved "
        f"{shared[0] / control[0]:.2f}x the control, "
        f"{shared[0] / max(each):.2f}x the largest size's on {smi}")
    if not shared[0] < control[0]:
        raise AssertionError("5c: one pool grew no less than a pool a size")
    del separate, graphed_model, optimizer, scheduler, batches
    memory_now()
    counts = launches()
    check_path_launches("training over shapes", counts, {
        cuda_fwd.KERNEL: steps * LAUNCHES_PER_FORWARD,
        cuda_bwd.KERNEL: steps * LAUNCHES_PER_FORWARD,
        cuda_matcher.KERNEL: steps * AUCTIONS_PER_STEP})
    log(f"5c: {steps} steps, launches {counts}")
    return counts


# Phase 5d: the auction's large-N path against the plain auction over the
# whole cost, and the published two-stage form's graphed step
LARGE_AUCTION_SHAPES = ((2, 22_223, 50), (1, 88_750, 50))


def large_auction_cases() -> list:
    """Phase 5d a's cases: ``(name, cost [B, N, M] f32, active [B, M] bool
    or None)`` on the card."""
    rng = np.random.default_rng(51)
    cases = []
    for shape in LARGE_AUCTION_SHAPES:
        B, _, M = shape
        uniform = rng.random(shape, dtype=np.float32)
        mask = np.zeros((B, M), bool)
        for b in range(B):
            mask[b, :rng.integers(5, 10)] = True  # as phase 5's targets
        for kind, cost, active in (
                # masked-out slots cost 0 everywhere, as in detection_loss
                ("masked", np.where(mask[:, None, :], uniform, 0), mask),
                ("masked ties", np.where(mask[:, None, :],
                                         np.floor(uniform * 4), 0), mask),
                ("uniform", uniform, None)):
            cases.append((f"{kind} {shape}", cost, active))
    return [(name, torch.as_tensor(cost, dtype=torch.float32,
                                   device=DEVICE).contiguous(),
             None if active is None else torch.as_tensor(active,
                                                         device=DEVICE))
            for name, cost, active in cases]


def check_large_auction(smi: str) -> dict:
    """Phase 5d a: the large-N path against ``plain_auction`` over the whole
    cost in every case, indices and flags equal, every case converged and
    routed to the path by ``auction_assignment``; each case timed beside
    the plain loop and the bound.  Returns the JSON row's numbers, from
    the first case (the proposal matching's shape at 800x1333)."""
    worst, row = 0, None
    for name, cost, active in large_auction_cases():
        q, conv, taken = cuda_auction_large.auction(cost, active,
                                                    AUCTION_EPS, 2000)
        want_q, want_conv = plain_auction(cost, active, AUCTION_EPS, 2000)
        before = launches()
        routed_q, routed_conv = auction_assignment(
            cost, active, AUCTION_EPS, 2000, return_state=True)
        routed = {k: launches()[k] - before[k]
                  for k in (cuda_matcher.KERNEL, cuda_auction_large.KERNEL)}
        same = (torch.equal(q, want_q) and torch.equal(conv, want_conv)
                and torch.equal(routed_q, want_q)
                and torch.equal(routed_conv, want_conv))
        ms = time_ms(lambda: cuda_auction_large.auction(  # noqa: B023
            cost, active, AUCTION_EPS, 2000), 20)
        plain_ms = time_ms(lambda: plain_auction(  # noqa: B023
            cost, active, AUCTION_EPS, 2000), 2)
        B, N, M = cost.shape
        nbytes = B * N * M * 4  # each cost read once
        bound_ms, bound_by = roofline_ms(nbytes, 0.0)
        taken = taken.tolist()
        log(f"large auction {name}: {'equal' if same else 'DIFFER'}, "
            f"converged {sum(conv.tolist())}/{B}, rounds {min(taken)}-"
            f"{max(taken)}; routed {routed}; path {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3e} ms by {bound_by} on "
            f"{smi}")
        if not same:
            raise AssertionError(f"large auction {name}: the path's "
                                 "query_idx or converged differ from the "
                                 "plain loop's")
        if not conv.all():
            raise AssertionError(f"large auction {name}: not converged")
        if routed != {cuda_matcher.KERNEL: 0, cuda_auction_large.KERNEL: 1}:
            raise AssertionError(f"large auction {name}: auction_assignment "
                                 f"launched {routed}, expected the large-N "
                                 "path once")
        worst = max(worst, (q - want_q).abs().max().item())
        if row is None:
            row = {"ms": ms, "plain_ms": plain_ms,
                   "bound": {"ms": bound_ms, "bound_by": bound_by}}
    log(f"large auction: every case equal to the plain loop; the "
        f"proposal matching's call {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.3f} ms, bound {row['bound']['ms']:.3e} ms)")
    return {**row, "err": float(worst)}


def published_path(smi: str) -> dict:
    """Phase 5d: the large-N path against the plain auction (a), then the
    published two-stage form's graphed step (b).  Returns the path's JSON
    numbers, every kernel's launches over the steps and in one step."""
    row = check_large_auction(smi)
    reset_launches()
    pyramid, targets = make_pyramid(30), make_targets(31)
    model = DeformableDetr(**MODEL, two_stage="published", device=DEVICE)
    model = init_parameters(model, torch.Generator().manual_seed(0)).train()
    optimizer = adamw(model)
    step = make_train_step(model, optimizer, SLICE_SHAPES,
                           return_metrics=True, **LOSS_KW)
    want = {cuda_fwd.KERNEL: LAUNCHES_PER_FORWARD,
            cuda_bwd.KERNEL: LAUNCHES_PER_FORWARD,
            cuda_matcher.KERNEL: AUCTIONS_PER_STEP,
            cuda_auction_large.KERNEL: 1}
    losses, times, per_step = [], [], None
    for i in range(1 + TRAIN_STEPS):
        before = launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, metrics = step(pyramid, targets)
        end.record()
        torch.cuda.synchronize()
        counts = {k: n - before[k] for k, n in launches().items()}
        per_step = per_step or counts
        losses.append(loss.item())
        times.append(start.elapsed_time(end))
        converged = bool(metrics["matcher_converged"])
        what = ("warm-up", "capture + replay")[i] if i < 2 else "replay"
        log(f"published step {i} ({what}): loss {losses[-1]:.6f} "
            f"matcher_converged {converged} {times[-1]:.3f} ms, launches "
            f"{counts}")
        check_path_launches(f"published step {i}", counts, want)
        if not converged or not np.isfinite(losses[-1]):
            raise AssertionError(f"published step {i}: matcher_converged "
                                 f"{converged}, loss {losses[-1]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"published: the loss did not fall on a "
                             f"repeated batch: {losses}")
    counts = launches()
    log(f"published: batch {BATCH} at {IMAGE_HW[0]}x{IMAGE_HW[1]}, mean "
        f"replayed step {sum(times[2:]) / len(times[2:]):.3f} ms, "
        f"launches {counts}; per step {per_step} on {smi}")
    del model, optimizer, step
    return {"auction": row, "counts": counts, "per_step": per_step}


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


K2_TRACED_CALLS = 10  # phase 6: K2's calls a trace, for its device split


def k2_split(call, tag: str) -> str:
    """Device ms a call of ``call`` by kernel, from a trace of
    ``K2_TRACED_CALLS`` calls."""
    with trace(os.path.join(TRACE_DIR, f"k2_{tag}")) as t:
        for _ in range(K2_TRACED_CALLS):
            call()
    return "; ".join(f"{kernel_name(kname)} {ms / K2_TRACED_CALLS:.4f}"
                     for kname, ms in t.kernel_ms().items())


def kernel_name(name: str) -> str:
    """A device event's kernel name without its namespace, template
    arguments and parameters."""
    found = re.search(r"\w*kernel\w*", name)
    return (found.group(0) if found else name)[:40]


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
            # the device time of the kernel and of the call's other device
            # work (img_grad's memset, the casts)
            log(f"time K2 {name:18s} {str(dtype)[6:]:8s}: device ms a call "
                f"by kernel: {k2_split(kernel, name)} on {smi}")
            del args, img, og
        del img32, pts, wts, og32
    for name in ("encoder", "decoder", "reference_workload"):
        f32, bf16 = (times[(name, d)][0] for d in (torch.float32,
                                                    torch.bfloat16))
        log(f"time K2 {name:18s}: bf16 / f32 {bf16 / f32:.3f} ({bf16:.4f} "
            f"against {f32:.4f} ms) on {smi}")
    return times


# phase 6b: the fused add + LayerNorm's rows (the 800x1333 encoder call,
# the decoder's batch 2 x 300 queries), calls a timed graph, and the bar
NORM_ROWS = {"encoder": 44_446, "decoder": 600}
NORM_DIM = 256
NORM_CALLS = 12
NORM_MIN_EQUAL = 0.99
NORM_ULP_FLOOR = 2.0**-10
NORM_MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def norm_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want|`` in ulps of the output dtype, each taken at the
    larger of the two magnitudes and ``NORM_ULP_FLOOR``."""
    g, w = got.float(), want.float()
    scale = torch.maximum(torch.maximum(g.abs(), w.abs()),
                          torch.tensor(NORM_ULP_FLOOR, device=g.device))
    _, exponent = torch.frexp(scale)
    return (g - w).abs() / torch.ldexp(
        torch.ones_like(scale), exponent - 1 - NORM_MANTISSA[got.dtype])


def graph_call_ms(fn, operands, repeats: int = 20) -> float:
    """The device time of one ``fn(*operands[i])``: ``len(operands)``
    calls captured as one CUDA graph, the median replay over them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in operands:  # load the kernels before the capture
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in operands:
            fn(*args)
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(operands))
    del graph
    return float(np.median(times))


def check_norm(smi: str) -> dict:
    """Phase 6b: ``cuda_norm.add_layer_norm`` against
    ``add_layer_norm_plain`` on the same card tensors, bf16 and f16, at the
    encoder's and the decoder's rows; each held to the bar, then both
    timed in turns (plain, kernel, kernel, plain).  Returns the JSON row's
    numbers, from the encoder call in bf16."""
    D, eps = NORM_DIM, LAYER_NORM_EPS
    g = torch.Generator(device=DEVICE).manual_seed(17)
    weight = 1 + 0.1 * torch.randn(D, generator=g, device=DEVICE)
    bias = 0.1 * torch.randn(D, generator=g, device=DEVICE)
    worst, row = 0.0, None
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float16):
            for name, rows in NORM_ROWS.items():
                operands = [tuple(
                    (torch.randn(rows, D, generator=g, device=DEVICE) * s
                     ).to(dtype) for s in (2.0, 1.0))
                    for _ in range(NORM_CALLS)]
                a, b = operands[0]
                before = cuda_norm.LAUNCHES
                got = cuda_norm.add_layer_norm(a, b, weight, bias, eps)
                want = cuda_norm.add_layer_norm_plain(a, b, weight, bias, eps)
                torch.cuda.synchronize()
                if cuda_norm.LAUNCHES != before + 1:
                    raise AssertionError("add + LayerNorm: the wrapper did "
                                         "not launch the kernel once")
                equal = (got == want).float().mean().item()
                ulps = norm_ulps(got, want).max().item()
                err = (got.float() - want.float()).abs().max().item()
                worst = max(worst, err)

                def kernel(x, y):
                    cuda_norm.add_layer_norm(x, y, weight, bias, eps)

                def plain(x, y):
                    cuda_norm.add_layer_norm_plain(x, y, weight, bias, eps)

                p1 = graph_call_ms(plain, operands)
                k1 = graph_call_ms(kernel, operands)
                k2 = graph_call_ms(kernel, operands)
                p2 = graph_call_ms(plain, operands)
                k, p = (k1 + k2) / 2, (p1 + p2) / 2
                b_ms, b_by = roofline_ms(6 * rows * D, 0.0)
                log(f"add + LayerNorm {name} {rows}x{D} {str(dtype)[6:]}: "
                    f"{equal:.4%} bitwise equal to the plain chain, at most "
                    f"{ulps:g} ulp, max_abs_err {err:.3e}; kernel {k:.5f} ms "
                    f"({k1:.5f}, {k2:.5f}), plain {p:.5f} ms ({p1:.5f}, "
                    f"{p2:.5f}), bound {b_ms:.5f} ms by {b_by} "
                    f"({b_ms / k:.1%}) on {smi}")
                if not (torch.isfinite(got).all().item()
                        and equal >= NORM_MIN_EQUAL and ulps <= 1):
                    raise AssertionError(
                        f"add + LayerNorm {name} {str(dtype)[6:]}: "
                        f"{equal:.4%} bitwise equal, {ulps:g} ulp apart "
                        f"(the bar: {NORM_MIN_EQUAL:.0%}, 1 ulp)")
                if row is None:  # the encoder call in bf16
                    row = {"ms": k, "plain_ms": p,
                           "bound": {"ms": b_ms, "bound_by": b_by}}
                del operands, got, want
    return {**row, "err": worst}


# phase 6c: K1's prologue variant at the model's own calls (encoder layer 0
# at 800x1333: I = 22,223 queries, the [I, 2] points expanded over the
# batch; decoder layer 0: 300 boxes), batch 2; calls a timed graph
QUERIES_CALLS = {"encoder": 0, "decoder": 6}
QUERIES_GRAPH_CALLS = 12
QUERIES_MANTISSA = {torch.float32: 23, torch.bfloat16: 7}


def output_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest ``|got - want|`` in ulps of the output dtype, an ulp
    taken at max(|want|, 1) (K1's outputs are held relative to
    max(1, |ref|), as ``tests/test_torch_kernels.py``)."""
    mag = want.double().abs().clamp(min=1.0)
    ulp = torch.exp2(torch.floor(torch.log2(mag))
                     - QUERIES_MANTISSA[want.dtype])
    return ((got.double() - want.double()).abs() / ulp).max().item()


def queries_bound(shapes, img, q, refs, pts, wts) -> dict:
    """The least time of one call of K1's prologue variant: ``bound``'s
    (img in the rows the points reach, the output) with q read once in its
    dtype and each stored value of the reference points once, in place of
    K1's f32 points and weights."""
    B, N, H, L, P, _ = q.shape
    k1 = bound(shapes, img, pts, wts, False)
    stored = refs.shape[1] * refs.shape[2] * (1 if refs.stride(0) == 0
                                              else B)
    nbytes = (k1["bytes"] - B * N * H * L * P * 12
              + q.numel() * q.element_size() + stored * 4)
    ms, bound_by = roofline_ms(nbytes, k1["flops"])
    return {"bytes": nbytes, "flops": k1["flops"], "ms": ms,
            "bound_by": bound_by}


def check_queries(smi: str) -> dict:
    """Phase 6c: K1's prologue variant (``cuda_fwd_queries``) on the model's
    own calls, bf16 and f32: against its plain version
    (``msda_fwd_queries_plain``, the chain and the plain MSDA) within K1's
    bar (``TOL``, relative to max(1, |plain|)); against the module's chain
    (``sampling_plain``) + K1 within one output ulp, the share bitwise
    equal; in f32, the variant's and the chain + K1's distance to the f64
    path (the chain and the plain MSDA in f64).  Then each side's device
    time, a call of a CUDA graph of ``QUERIES_GRAPH_CALLS`` calls on fresh
    operands replayed, in turns (chain, variant, variant, chain), beside the
    variant's bound (``queries_bound``) and the plain version's time.
    Returns the JSON row's numbers: the times from the encoder call in bf16,
    ``err`` the largest f32 abs error against the plain version (as K1's
    row), and the chain + K1 comparison and the f64 distances apart."""
    args = ("reference", "border", False)
    worst, row = 0.0, None
    chain_k1 = {"ulps": 0.0, "bitwise": 1.0}
    wide_gap = {"variant": 0.0, "chain_k1": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for name, call in QUERIES_CALLS.items():
            img, shapes, q, refs = model_queries(
                IMAGE_HW, BATCH, call,
                None if dtype == torch.float32 else dtype)
            hw = torch.tensor(shapes, dtype=torch.float32, device=DEVICE)
            with torch.inference_mode():
                before = forward_launches()
                got = cuda_fwd_queries.msda_fwd_queries(img, shapes, q, refs,
                                                        *args)
                pts, wts = cuda_fwd_queries.sampling_plain(q, refs, shapes,
                                                           args[0], hw)
                want = cuda_fwd.msda_fwd(img, shapes, pts, wts, *args[1:])
                torch.cuda.synchronize()
                after = forward_launches()
                if (after[0] - before[0], after[1] - before[1]) != (1, 1):
                    raise AssertionError("6c: a call launched the variant "
                                         "or K1 other than once")
                plain_out = cuda_fwd_queries.msda_fwd_queries_plain(
                    img, shapes, q, refs, *args)
                err, _, mixed = errors(got, plain_out)
                if dtype == torch.float32:
                    worst = max(worst, err)
                    wide = cuda_fwd_queries.msda_fwd_queries_plain(
                        img.double(), shapes, q.double(), refs.double(),
                        *args)
                    scale = wide.abs().clamp(min=1.0)
                    gaps = [((x.double() - wide) / scale).abs().max().item()
                            for x in (got, want)]
                    wide_gap = {"variant": max(wide_gap["variant"], gaps[0]),
                                "chain_k1": max(wide_gap["chain_k1"],
                                                gaps[1])}
                    del wide, scale
                equal = (got == want).float().mean().item()
                ulps = output_ulps(got, want)
                chain_k1 = {"ulps": max(chain_k1["ulps"], ulps),
                            "bitwise": min(chain_k1["bitwise"], equal)}
                operands = [(img.clone(), q.clone(), refs)
                            for _ in range(QUERIES_GRAPH_CALLS)]

                def variant(x, y, r):
                    cuda_fwd_queries.msda_fwd_queries(x, shapes, y, r, *args)

                def chain(x, y, r):
                    p_, w_ = cuda_fwd_queries.sampling_plain(y, r, shapes,
                                                             args[0], hw)
                    cuda_fwd.msda_fwd(x, shapes, p_, w_, *args[1:])

                c1 = graph_call_ms(chain, operands)
                k1 = graph_call_ms(variant, operands)
                k2 = graph_call_ms(variant, operands)
                c2 = graph_call_ms(chain, operands)
                plain = time_ms(lambda: cuda_fwd_queries.msda_fwd_queries_plain(
                    img, shapes, q, refs, *args), 2)
            k, c = (k1 + k2) / 2, (c1 + c2) / 2
            b = queries_bound(shapes, img, q, refs, pts, wts)
            wide_text = (f"; distance to the f64 path {gaps[0]:.3e}, the "
                         f"chain + K1's {gaps[1]:.3e}"
                         if dtype == torch.float32 else "")
            log(f"6c prologue variant {name} {tuple(q.shape)} "
                f"{str(dtype)[6:]}: against the plain version max_abs "
                f"{err:.3e} err {mixed:.3e} (tol {TOL[dtype]:g}); "
                f"{equal:.4%} bitwise equal to the chain + K1, at most "
                f"{ulps:g} ulp{wide_text}; variant "
                f"{k:.5f} ms ({k1:.5f}, {k2:.5f}), chain + K1 {c:.5f} ms "
                f"({c1:.5f}, {c2:.5f}), {c / k:.2f}x; plain {plain:.4f} ms; "
                f"bound {b['ms']:.5f} ms ({b['bound_by']}: {b['bytes']} B), "
                f"{100 * b['ms'] / k:.1f}% of it on {smi}")
            if not (torch.isfinite(got).all().item() and mixed <= TOL[dtype]):
                raise AssertionError(
                    f"6c {name} {str(dtype)[6:]}: the variant is {mixed:.3e} "
                    f"from its plain version (the bar: {TOL[dtype]:g})")
            if ulps > 1:
                raise AssertionError(
                    f"6c {name} {str(dtype)[6:]}: the variant is {ulps:g} "
                    "ulp from the chain + K1 (the bar: 1)")
            if row is None:  # the encoder call in bf16
                row = {"ms": k, "plain_ms": plain, "chain_ms": c, "bound": b}
            del img, q, refs, pts, wts, operands, got, want, plain_out
    return {**row, "err": worst, "chain_k1": chain_k1, "f64_gap": wide_gap}


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
    size = img[0].numel() * img.element_size()
    log(f"{name}: one image's pyramid {size} bytes; stream.FORCE "
        f"{stream.FORCE}")
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
    """Phase 7b: the op's two paths.  At the 512-base pyramid (B=2) an
    unforced call runs K1 forward and K2 backward; with
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


def benchmark_row(smi: str) -> None:
    """Phase 7d: the benchmark entry point at the 256-base pyramid."""
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
# the exported model's mean graphed request in the serving process, at most
# this many times phase 4's live graphed mean (the card's host noise alone
# moved eager serving by up to 1.4x between calls)
EXPORT_SLOWDOWN_MAX = 2.0
SPANS = ("encoder", "decoder", "postprocess", "loss", "backward",
         "optimizer")

# The serving process of phase 8b: it imports torch, numpy and
# msda_tpu_torch.utils.export only, loads each artifact (graphed by
# load_exported_file), serves a warm-up and the capture, then the requests
# of REQUEST_SEEDS (built as make_pyramid builds them) graphed and eager
# (__wrapped__, the program run node by node) in turns, counts the kernels'
# launches a request (ops.launches: the wrappers that the operator loaded),
# times each request with CUDA events, saves the graphed detections and
# prints a JSON line.
_SERVE_EXPORTED = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from msda_tpu_torch.utils.export import load_exported_file

spec = json.loads(sys.argv[2])


def counts():
    from msda_tpu_torch.ops import launches
    return launches.counts()


def pyramid(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (spec["batch"], h, w, c), dtype=np.float32)).cuda()
        for (h, w), c in zip(spec["shapes"], spec["channels"])]


def launched():  # (K1's prologue variant, K1) launches so far
    now = counts()
    return now.get("msda_fwd_queries", 0), now.get("msda_fwd", 0)


def timed(fn, pyr):
    before = launched()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    det = fn(*pyr)
    end.record()
    torch.cuda.synchronize()
    after = launched()
    return det, start.elapsed_time(end), [after[0] - before[0],
                                          after[1] - before[1]]


result = {}
for name in spec["models"]:
    serve = load_exported_file(f"{spec['dir']}/{name}.pt2")
    requests = [pyramid(seed) for seed in spec["seeds"]]
    per_forward, times = [], {"graphed": [], "eager": []}
    with torch.inference_mode():
        # the warm-up (builds the kernels), then the capture and its replay
        for _ in range(2):
            per_forward.append(timed(serve, requests[0])[2])
        for i, pyr in enumerate(requests):
            for mode in ("graphed", "eager")[::1 if i % 2 == 0 else -1]:
                det, ms, k1 = timed(
                    serve if mode == "graphed" else serve.__wrapped__, pyr)
                times[mode].append(ms)
                per_forward.append(k1)
                if mode == "graphed":
                    torch.save({k: v.cpu() for k, v in det.items()},
                               f"{spec['dir']}/{name}_{i}.pt")
    result[name] = {"per_forward": per_forward, "ms": times["graphed"],
                    "eager_ms": times["eager"], "forwards": len(per_forward)}
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
    postprocess in f32 and bf16, serve the artifacts through
    ``load_exported_file``'s graphed callable in a process that never built
    the model, and hold its detections against the live graphed request's
    and its mean against phase 4's live graphed mean (``live_ms``).
    Returns every kernel's launch count in that process."""
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
        live_fn = graphed(serve_fn)
        requests = [make_pyramid(s) for s in REQUEST_SEEDS]
        with torch.inference_mode():
            for _ in range(2):  # the warm-up; the capture and its replay
                live_fn(*requests[0])
            live[name] = [live_fn(*pyr) for pyr in requests]
        del model, blob, live_fn, requests
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
        if got["per_forward"] != [[LAUNCHES_PER_FORWARD, 0]] * got[
                "forwards"]:
            raise AssertionError(
                f"exported {name}: (K1's prologue variant, K1) launches a "
                f"request {got['per_forward']}, expected "
                f"[{LAUNCHES_PER_FORWARD}, 0]")
        forwards += got["forwards"]
        worst = 0.0
        for i, want in enumerate(dets):
            det = torch.load(os.path.join(EXPORT_DIR, f"{name}_{i}.pt"))
            check_detections(det)
            if not torch.equal(det["labels"], want["labels"].cpu()):
                raise AssertionError(f"exported {name}, request {i}: the "
                                     "labels differ from the live graphed "
                                     "request's")
            for k in ("scores", "boxes"):
                worst = max(worst, errors(det[k], want[k].cpu())[2])
        ok = worst <= EXPORT_TOL[name]
        ms, eager_ms = got["ms"], got["eager_ms"]
        mean, eager_mean = sum(ms) / len(ms), sum(eager_ms) / len(eager_ms)
        log(f"exported {name}: {len(dets)} graphed requests against the "
            f"live graphed ones, labels equal, scores/boxes err {worst:.3e} "
            f"(tol {EXPORT_TOL[name]:g}) {'ok' if ok else 'FAIL'}; "
            f"(K1's prologue variant, K1) a request {got['per_forward']}; "
            f"graphed per-request ms "
            f"{', '.join(f'{t:.3f}' for t in ms)} (mean {mean:.3f}; live "
            f"graphed, phase 4: {live_ms[name]:.3f}); eager (__wrapped__, "
            f"node by node) in turns {', '.join(f'{t:.3f}' for t in eager_ms)}"
            f" (mean {eager_mean:.3f}); {served['free_bytes']} bytes free at "
            f"the end, on {smi}")
        if not ok:
            raise AssertionError(f"exported {name}: detections differ from "
                                 "the live graphed request's")
        ratio = mean / live_ms[name]
        log(f"exported {name}: serving process graphed / live graphed mean "
            f"{ratio:.2f}x (bar {EXPORT_SLOWDOWN_MAX:g}x); its eager / "
            f"graphed {eager_mean / mean:.2f}x")
        if ratio > EXPORT_SLOWDOWN_MAX:
            raise AssertionError(f"exported {name} serves {ratio:.2f}x "
                                 "slower than the live graphed request")
    counts = served["launches"]
    check_path_launches("export", counts, {
        cuda_fwd_queries.KERNEL: forwards * LAUNCHES_PER_FORWARD,
        cuda_norm.KERNEL: (served["bf16"]["forwards"]
                           * NORMS_PER_HALF_FORWARD)})
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
        f"{name} {host.get(name, float('nan')):.3f} / "
        f"{device.get(name, float('nan')):.3f}"
        for name in SPANS if name in host or name in device))


def profile_paths(smi: str, serve_ms: dict, eager_step_ms: float,
                  graphed: tuple) -> None:
    """Phase 8c: one f32 serving request, eager (``__wrapped__``, for the
    spans) and graphed (a replay, 12 launches of K1's prologue variant in
    the trace and no K1), one replay of the
    exported bf16 program (the device time of its casts and copies), and
    one eager f32 training step, each after its warm-up, under
    ``utils.profile.trace``; ``serve_ms`` is phase 4's mean request,
    ``eager_step_ms`` 5b's eager f32 step and ``graphed`` 5b's graphed
    replay (window, busy, idle share)."""
    image_sizes = torch.tensor([IMAGE_HW] * BATCH, device=DEVICE)
    pyramid = make_pyramid(REQUEST_SEEDS[0])
    model = build_model("auto", True)
    fn = serving_fn(model)
    with torch.inference_mode():
        for _ in range(2):  # the warm-up; the capture and its replay
            fn(pyramid, image_sizes)
        torch.cuda.synchronize()
        with trace(os.path.join(TRACE_DIR, "serve_f32")) as t:
            fn.__wrapped__(pyramid, image_sizes)
        report_trace("serving f32 request (eager)", t,
                     serve_ms["f32"]["eager"], smi)
        before = forward_launches()
        with trace(os.path.join(TRACE_DIR, "serve_f32_graphed")) as t:
            fn(pyramid, image_sizes)
        after = forward_launches()
    counted = (after[0] - before[0], after[1] - before[1])
    traced = tuple(sum(n for kname, n in t.kernel_counts().items()
                       if pattern in kname)
                   for pattern in ("msda_fwd_queries_kernel",
                                   "msda_fwd_kernel"))
    report_trace("serving f32 request (graphed, a replay)", t,
                 serve_ms["f32"]["graphed"], smi)
    log(f"  (K1's prologue variant, K1) in the graphed request's trace "
        f"{traced}, counted {counted}")
    if traced != (LAUNCHES_PER_FORWARD, 0) or counted != traced:
        raise AssertionError(
            f"a graphed request launched (K1's prologue variant, K1) "
            f"{traced} times (trace), {counted} (counters); expected "
            f"({LAUNCHES_PER_FORWARD}, 0)")
    del model, fn

    serve = load_exported_file(os.path.join(EXPORT_DIR, "bf16.pt2"))
    with torch.inference_mode():
        for _ in range(2):
            serve(*pyramid)
        torch.cuda.synchronize()
        with trace(os.path.join(TRACE_DIR, "serve_bf16_exported")) as t:
            serve(*pyramid)
    kernels, launched = t.kernel_ms(), t.kernel_counts()
    copies = [k for k in kernels if "copy" in k]
    busy = t.busy_ms()
    log(f"profile exported bf16 program, a replay: window "
        f"{t.window_ms:.3f} ms, busy {busy:.3f} ms, idle "
        f"{100 * t.idle_share():.1f}%; copy kernels (the weight casts "
        f"among them) {sum(launched[k] for k in copies)} launches, "
        f"{sum(kernels[k] for k in copies):.3f} ms of device time on {smi} "
        f"({os.path.relpath(t.path, ROOT)})")
    del serve

    pyramid, targets = make_pyramid(30), make_targets(31)
    model = build_model("auto", True).train()
    step = make_train_step(model, adamw(model), SLICE_SHAPES,
                           return_metrics=True, **LOSS_KW).__wrapped__
    step(pyramid, targets)
    torch.cuda.synchronize()
    with trace(os.path.join(TRACE_DIR, "train_f32")) as t:
        loss, _ = step(pyramid, targets)
    if not np.isfinite(loss.item()):
        raise AssertionError("profiled training step: loss not finite")
    report_trace("training f32 step (eager)", t, eager_step_ms, smi)
    window, busy, idle = graphed
    log(f"  the graphed f32 replay (5b): window {window:.3f} ms, busy "
        f"{busy:.3f} ms, idle {100 * idle:.1f}%")


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


def _mesh_serve(model, pyramid, image_sizes, mesh: bool):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    before = cuda_fwd.LAUNCHES
    start.record()
    out, det = serve_once(model, pyramid, image_sizes, mesh)
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
            serve_once(sharded, pyramid, image_sizes, mesh=True)
            served = launches()
            times = {"mesh": [], "unsharded": []}
            for _ in range(3):  # in turns: the request is host-bound
                before = launches()
                got, k1, ms = _mesh_serve(sharded, pyramid, image_sizes,
                                          mesh=True)
                after = launches()
                served = {k: served[k] + after[k] - before[k]
                          for k in served}
                times["mesh"].append(ms)
                want, _, ms = _mesh_serve(plain, pyramid, image_sizes,
                                          mesh=False)
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
        worst, worst_name, strict = parameter_error(
            dict(sharded.named_parameters()),
            dict(plain.named_parameters()))
        step_counts = results["mesh"][1]
        launched = (step_counts[cuda_fwd.KERNEL],
                    step_counts[cuda_bwd.KERNEL],
                    step_counts[cuda_matcher.KERNEL])
        log(f"mesh train step (f32, SGD lr {MESH_LR:g}): loss "
            f"{results['mesh'][0]:.6f}, unsharded "
            f"{results['unsharded'][0]:.6f} (rel {loss_err:.2e}); "
            f"parameters worst {worst:.2e} of the tensor's largest, at "
            f"least {GRAD_FLOOR:g} of the model's largest ({worst_name}; "
            f"tol {MESH_TOL:g}; {strict:.2e} of the tensor's largest "
            f"alone); K1 {launched[0]} K2 {launched[1]} auction "
            f"{launched[2]} a step on {smi}")
        if not (loss_err <= MESH_TOL and worst <= MESH_TOL and launched == (
                LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD,
                AUCTIONS_PER_STEP)):
            raise AssertionError("the mesh step differs from the unsharded "
                                 "step")
        counts = {k: served[k] + step_counts[k] for k in served}
        # 4 forwards (a warm-up and 3 requests) and one step
        check_path_launches("mesh", counts, {
            cuda_fwd.KERNEL: 5 * LAUNCHES_PER_FORWARD,
            cuda_bwd.KERNEL: LAUNCHES_PER_FORWARD,
            cuda_matcher.KERNEL: AUCTIONS_PER_STEP})
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
    # the op's kernels: the headline process runs the op alone
    op_kernels = set(launches()) - {cuda_matcher.KERNEL, cuda_norm.KERNEL,
                                    cuda_auction_large.KERNEL,
                                    cuda_fwd_queries.KERNEL}
    if len(counts) != 1 or set(counts[0]) != op_kernels:
        raise AssertionError(f"headline: launch counts {counts}, expected "
                             f"one line with the keys {sorted(op_kernels)}")
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
    graph_serving(smi)
    served_shapes = serve_shapes(
        smi, {name: ms["graphed"] for name, ms in serve_ms.items()})
    trained, per_train_step = train(smi)
    step_graphs = graph_path(smi)
    trained_shapes = train_shapes(smi)
    published = published_path(smi)
    by_path = {"serve": served, "serve_shapes": served_shapes,
               "train": trained, "train_shapes": trained_shapes,
               "train_published": published["counts"],
               **large_pyramid_path(smi)}
    times = {cuda_fwd.KERNEL: time_kernel(smi),
             cuda_bwd.KERNEL: time_backward_kernel(smi)}
    norm = check_norm(smi)
    errs[cuda_norm.KERNEL] = norm["err"]
    queries = check_queries(smi)
    errs[cuda_fwd_queries.KERNEL] = queries["err"]
    time_big_pyramid(smi)
    stream_times = time_stream_kernels(smi)
    benchmark_row(smi)
    opcheck_on_card()
    by_path["export"] = export_path(
        smi, {name: ms["graphed"] for name, ms in serve_ms.items()})
    profile_paths(smi, serve_ms, step_graphs["times"]["f32"]["eager"],
                  step_graphs["profile"])
    entry_points(smi)
    dryrun_cpu(smi)
    by_path["mesh"] = mesh_path(smi)
    by_path.update(hf_parity(smi))
    autotune_short(smi)
    by_path["headline"] = headline_lines(smi)
    auction = step_graphs["auction"]
    errs[cuda_matcher.KERNEL] = auction["err"]
    large = published["auction"]
    errs[cuda_auction_large.KERNEL] = large["err"]
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        if name in times:  # K1, K2: the encoder shape, f32
            ms, plain_ms, b = times[name][("encoder", torch.float32)]
        elif name == cuda_matcher.KERNEL:  # a step's first head's costs
            ms, plain_ms, b = auction["ms"], auction["plain_ms"], (
                auction["bound"])
        elif name == cuda_auction_large.KERNEL:  # (2, 22223, 50), masked
            ms, plain_ms, b = large["ms"], large["plain_ms"], large["bound"]
        elif name == cuda_norm.KERNEL:  # the 800x1333 encoder call, bf16
            ms, plain_ms, b = norm["ms"], norm["plain_ms"], norm["bound"]
        elif name == cuda_fwd_queries.KERNEL:  # the same call, bf16
            ms, plain_ms, b = (queries["ms"], queries["plain_ms"],
                               queries["bound"])
        else:  # the streamed kernels: the 256-base pyramid, f32
            ms, plain_ms, b = stream_times[(name, torch.float32)]
        # a process counts the kernels whose wrappers it imported: the
        # headline and serving processes run the op alone
        paths = {path: counts[name] for path, counts in by_path.items()
                 if name in counts}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "launches_per_train_step": per_train_step[name],
            "launches_per_published_step": published["per_step"][name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b["ms"],
            "bound_by": b["bound_by"],
            # no single PyTorch call computes MSDA (grid_sample per level,
            # then the weights, then a sum), the binning, an assignment or
            # a sum's LayerNorm
            "library_ms": None,
        })
        if name == cuda_fwd_queries.KERNEL:
            # what it replaces on the main path, the chain and K1: its time,
            # the widest gap in output ulps and the least bitwise share; and
            # in f32 the distance of each to the f64 path, relative to
            # max(1, |f64|)
            kernels[-1]["chain_ms"] = queries["chain_ms"]
            kernels[-1]["chain_k1_max_ulps"] = queries["chain_k1"]["ulps"]
            kernels[-1]["chain_k1_bitwise"] = queries["chain_k1"]["bitwise"]
            kernels[-1]["f64_gap"] = queries["f64_gap"]
        if name == cuda_matcher.KERNEL:
            kernels[-1]["limited_by"] = (
                "latency: rounds x one round's scans, shuffles and "
                "barriers, a block an image")
        if name == cuda_auction_large.KERNEL:
            kernels[-1]["limited_by"] = (
                "latency: the select kernel's radix passes over a target's "
                "costs, a block a target and image; then the auction's "
                "rounds")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
