#!/usr/bin/env python3
"""Where HF Grounding DINO's stock and patched runs part, at its published
config (``detection_parity.build_grounding_dino("full")``, seed 0, one
800x1333 image).

    python3 docs/experiments/torch_gd_proposal_ties.py [--device cpu]

Runs the model stock and with its MSDA core patched to call this port's
op (``detection_parity.patched``), and prints, for each output, the
largest difference between the two runs; then the decoder's query slots
whose initial reference point differs (a proposal that traded places in
the two-stage top-k), and the top-k scores around them in the stock run.
On the CPU the port's op runs its plain version.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from msda_tpu_torch import detection_parity as dp  # noqa: E402

FIELDS = ("encoder_last_hidden_state_vision", "enc_outputs_class",
          "init_reference_points", "logits", "pred_boxes")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    model = dp.build_grounding_dino("full", seed=0).to(args.device)
    kwargs = dp.model_inputs("grounding-dino", "full", 0, args.device)
    with torch.no_grad():
        stock = model(**kwargs)
        with dp.patched(model):
            ours = model(**kwargs)
    for name in FIELDS:
        a, b = getattr(stock, name).float(), getattr(ours, name).float()
        finite = torch.isfinite(a) & torch.isfinite(b)
        diff = (a[finite] - b[finite]).abs().max().item()
        print(f"{name:34s} {tuple(a.shape)} max abs diff {diff:.3e} "
              f"(largest |value| {a[finite].abs().max().item():.3e})")
    moved = ((stock.init_reference_points - ours.init_reference_points)
             .abs().amax(-1)[0] > 1e-5).nonzero().flatten().tolist()
    print(f"slots that start from another proposal: {moved}")
    scores = stock.enc_outputs_class.float().amax(-1)[0]
    top = scores.sort(descending=True).values
    for slot in moved:
        lo, hi = max(slot - 1, 0), slot + 2
        print(f"stock top-k scores at ranks {lo}..{hi - 1}: "
              f"{[round(v, 6) for v in top[lo:hi].tolist()]}")
    print(f"on {args.device}")


if __name__ == "__main__":
    main()
