"""End-to-end training demo: Deformable DETR on synthetic detection data.

The counterpart of ``scripts/train_demo.py``, single device: the DETR model
with iterative box refinement, the auction-matched detection loss with deep
supervision, ``make_train_step`` with AdamW, and atomic checkpoints with
resume, on synthetic boxes (the same small model and batch).

Usage:
    python -m msda_tpu_torch.train_demo [--device cuda] [--steps 20]
        [--ckpt-dir build/train_demo_ckpt] [--class-loss ce|focal] [--bf16]

``--device`` defaults to ``cuda`` and is taken as given: without a GPU, pass
``--device cpu`` (the op then runs its plain version).  A run resumes from
the latest checkpoint under ``--ckpt-dir``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .models import DeformableDetr, init_parameters
from .parallel import TrainCheckpointer, make_train_step

SHAPES = ((16, 16), (8, 8), (4, 4))
NUM_CLASSES = 8
NUM_QUERIES = 16
FEAT_C = 32
DEFAULT_CKPT_DIR = (Path(__file__).resolve().parents[1] / "build"
                    / "train_demo_ckpt")


def synthetic_batch(rng: np.random.Generator, batch: int, device):
    """Features + consistent targets: each image contains a few 'objects'
    whose features are bumps the model can learn to localize (the JAX
    demo's batch, drawn the same way from ``rng``)."""
    pyramid = [
        rng.standard_normal((batch, h, w, FEAT_C)).astype(np.float32) * 0.1
        for h, w in SHAPES
    ]
    m = NUM_QUERIES
    labels = rng.integers(0, NUM_CLASSES - 1, (batch, m)).astype(np.int32)
    boxes = rng.random((batch, m, 4)).astype(np.float32)
    boxes[..., 2:] = 0.1 + 0.2 * boxes[..., 2:]  # sane widths/heights
    mask = (rng.random((batch, m)) < 0.5).astype(np.float32)
    mask[:, 0] = 1.0
    # paint a feature bump at each object's center on level 0
    h0, w0 = SHAPES[0]
    for b in range(batch):
        for j in range(m):
            if mask[b, j]:
                cx = min(int(boxes[b, j, 0] * w0), w0 - 1)
                cy = min(int(boxes[b, j, 1] * h0), h0 - 1)
                pyramid[0][b, cy, cx, labels[b, j] % FEAT_C] += 2.0
    targets = {
        "labels": torch.from_numpy(labels).to(device),
        "boxes": torch.from_numpy(boxes).to(device),
        "mask": torch.from_numpy(mask).to(device),
    }
    return [torch.from_numpy(p).to(device) for p in pyramid], targets


def main(argv=None) -> list[float]:
    """Run the demo; returns the losses of the steps it took."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--class-loss", choices=["ce", "focal"], default="ce",
                    help="classification objective: softmax CE with "
                         "background or sigmoid focal")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 mixed precision: f32 master weights, bf16 "
                         "transformer stack")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but no CUDA GPU is visible; pass "
                         "--device cpu to train on the CPU")
    rng = np.random.default_rng(0)
    model = DeformableDetr(
        num_classes=NUM_CLASSES, in_channels=[FEAT_C] * len(SHAPES),
        emb_dim=64, num_heads=4, num_points=2, num_queries=NUM_QUERIES,
        num_encoder_layers=1, num_decoder_layers=2, ffn_dim=128,
        with_box_refinement=True,
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=device,
    )
    init_parameters(model, torch.Generator().manual_seed(0))
    pyramid, targets = synthetic_batch(rng, args.batch, device)
    # optax.adamw(3e-4) of the JAX demo, whose weight decay is 1e-4
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4)

    ckpt = TrainCheckpointer(args.ckpt_dir)
    start = 0
    if ckpt.steps():
        start = ckpt.restore(model, optimizer)
        print(f"resumed from step {start}")

    train_step = make_train_step(model, optimizer, SHAPES, matcher="auction",
                                 class_loss=args.class_loss,
                                 return_metrics=True)
    losses = []
    t0 = time.perf_counter()
    for step in range(start, start + args.steps):
        loss, metrics = train_step(pyramid, targets)
        losses.append(loss)
        if (step + 1) % 5 == 0 or step == start:
            # read the matcher flag only on logging steps: reading it syncs
            # with the device
            matched = bool(metrics["matcher_converged"])
            flag = "" if matched else "  [matcher NOT converged]"
            print(f"step {step + 1:4d}  loss {float(loss):.4f}{flag}")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, model, optimizer)
    losses = [float(v) for v in losses]
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1) * 1e3:.1f} ms/step) on {device}; "
          f"checkpoints: {ckpt.steps()} under {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
