"""Full-model detection parity: HuggingFace detectors, stock against patched
with this port's op (the counterpart of ``scripts/detection_parity.py``).

HuggingFace's ``DeformableDetrForObjectDetection`` and
``GroundingDinoForObjectDetection`` each run one image twice: once stock,
once with their ``MultiScaleDeformableAttention`` patched to call
``msda_tpu_torch.multiscale_deformable_attention(value, shapes, loc, aw,
"zeros", False)`` on the tensors' own device (HF's semantics: zeros
padding, ``align_corners=False``), so on a card through K1.  The ranked
top-k detections must be identical and the boxes within 1e-3.

A two-stage model (Grounding DINO) seeds its decoder with the top-k
encoder proposals, and their order is not a property of the op: proposals
whose scores differ by less than the op's rounding can trade places
between two implementations that agree to 1e-6 (on the CPU, the full
configuration's ranks 324 and 325 swap).  The two runs must select the
same set of proposals; the slots that start from another proposal than
in the stock run are left out of the logits' and boxes' differences and
counted, and the boxes' difference over every slot is recorded too.

    python -m msda_tpu_torch.detection_parity [--model deformable-detr
        grounding-dino] [--size small|full] [--device cuda|cpu]

``--size small`` is the JAX script's tiny configurations on a 128x128
image; ``--size full`` the published ones (``DeformableDetrConfig()`` with
a ResNet-50 from ``ResNetConfig``; ``GroundingDinoConfig()``: Swin-T, a
BERT-base text encoder, 900 queries, 6+6 layers) on one 800x1333 image.
Weights are random from a seed (there are no pretrained weights offline)
and the ``input_ids`` fixed, so no tokenizer is needed.  Each model's
result goes to ``build/detection_parity/<model>-<size>.json``.  TF32 is
off on both sides.  The HF class and its ``forward`` signature are
resolved when the model is built, and an unknown signature raises.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .ops import cuda_fwd, multiscale_deformable_attention

__all__ = ["build_model", "build_grounding_dino", "patched_msda_forward",
           "patched", "model_inputs", "detect", "run_parity", "main",
           "MODELS"]

MODELS = ("deformable-detr", "grounding-dino")
OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "detection_parity"
IMAGE = {"small": (128, 128), "full": (800, 1333)}
# [CLS] t t t [SEP]: valid ids in the toy vocabulary and in BERT-base's
INPUT_IDS = [[101, 7, 8, 9, 102]]
BOXES_TOL = 1e-3


def build_model(size: str = "small", num_labels: int = 7, seed: int = 0):
    """HF ``DeformableDetrForObjectDetection``, random from ``seed``, in
    eval mode on the CPU: the JAX script's tiny configuration, or the
    published one (``num_labels`` is then the config's own 91)."""
    from transformers import (DeformableDetrConfig,
                              DeformableDetrForObjectDetection, ResNetConfig)

    if size == "full":
        cfg = DeformableDetrConfig(
            use_timm_backbone=False, backbone=None,
            backbone_config=ResNetConfig(
                out_features=["stage2", "stage3", "stage4"]),
            use_pretrained_backbone=False)
    else:
        bb = ResNetConfig(
            num_channels=3, embedding_size=16,
            hidden_sizes=[16, 32, 64, 128], depths=[1, 1, 1, 1],
            out_features=["stage2", "stage3", "stage4"])
        cfg = DeformableDetrConfig(
            d_model=64, encoder_layers=2, decoder_layers=2, num_queries=16,
            encoder_ffn_dim=128, decoder_ffn_dim=128,
            encoder_attention_heads=4, decoder_attention_heads=4,
            num_feature_levels=4, use_pretrained_backbone=False,
            use_timm_backbone=False, backbone=None, backbone_config=bb,
            num_labels=num_labels)
    torch.manual_seed(seed)
    return DeformableDetrForObjectDetection(cfg).eval()


def build_grounding_dino(size: str = "small", seed: int = 0):
    """HF ``GroundingDinoForObjectDetection``, random from ``seed``, in
    eval mode on the CPU: the JAX script's tiny configuration (a Swin
    backbone and a one-layer BERT), or ``GroundingDinoConfig()``'s."""
    from transformers import (BertConfig, GroundingDinoConfig,
                              GroundingDinoForObjectDetection)
    from transformers.models.swin.configuration_swin import SwinConfig

    if size == "full":
        cfg = GroundingDinoConfig()
    else:
        text_cfg = BertConfig(
            vocab_size=120, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)
        bb = SwinConfig(
            image_size=128, patch_size=4, embed_dim=16, depths=[1, 1, 1],
            num_heads=[1, 2, 4], out_features=["stage1", "stage2", "stage3"],
            window_size=4)
        cfg = GroundingDinoConfig(
            backbone_config=bb, text_config=text_cfg.to_dict(),
            d_model=64, encoder_layers=1, decoder_layers=1, num_queries=16,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            encoder_attention_heads=4, decoder_attention_heads=4,
            num_feature_levels=4)
    torch.manual_seed(seed)
    return GroundingDinoForObjectDetection(cfg).eval()


def _msda_classes(model) -> list[type]:
    """The classes of ``model``'s modules named
    ``MultiScaleDeformableAttention`` (HF's MSDA core, wherever a
    transformers version defines it)."""
    found = []
    for module in model.modules():
        cls = type(module)
        if cls.__name__ == "MultiScaleDeformableAttention" and (
                cls not in found):
            found.append(cls)
    if not found:
        raise RuntimeError(f"{type(model).__name__} has no "
                           "MultiScaleDeformableAttention module")
    return found


def patched_msda_forward(stock_forward):
    """A replacement for HF's ``MultiScaleDeformableAttention.forward``
    (``stock_forward``) that calls this port's op.  The arguments are bound
    by the stock signature's names, so that positional and keyword calls
    both work; a signature without ``value``, ``sampling_locations``,
    ``attention_weights`` and the level shapes raises."""
    sig = inspect.signature(stock_forward)
    names = set(sig.parameters)
    shapes_arg = next((n for n in ("value_spatial_shapes_list",
                                   "value_spatial_shapes",
                                   "spatial_shapes_list", "spatial_shapes")
                       if n in names), None)
    needed = {"value", "sampling_locations", "attention_weights"}
    if shapes_arg is None or not needed <= names:
        raise RuntimeError(
            f"unknown MultiScaleDeformableAttention.forward signature {sig}")

    def forward(self, *args, **kwargs):
        bound = sig.bind(self, *args, **kwargs).arguments
        value = bound["value"]
        shapes = [(int(h), int(w)) for h, w in bound[shapes_arg]]
        out = multiscale_deformable_attention(
            value, shapes, bound["sampling_locations"],
            bound["attention_weights"], "zeros", False)
        b, n, h, d = out.shape
        return out.reshape(b, n, h * d)

    return forward


@contextlib.contextmanager
def patched(model):
    """Within the block, ``model``'s MSDA core runs this port's op."""
    classes = _msda_classes(model)
    stock = [cls.forward for cls in classes]
    try:
        for cls, fwd in zip(classes, stock):
            cls.forward = patched_msda_forward(fwd)
        yield
    finally:
        for cls, fwd in zip(classes, stock):
            cls.forward = fwd


def model_inputs(model_name: str, size: str, seed: int = 0,
                 device="cpu") -> dict:
    """The request: one seeded standard-normal image of ``IMAGE[size]``
    (batch 1), and for Grounding DINO the fixed ``input_ids``."""
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.standard_normal(
        (1, 3, *IMAGE[size])).astype(np.float32)).to(device)
    kwargs = {"pixel_values": image}
    if model_name == "grounding-dino":
        kwargs["input_ids"] = torch.tensor(INPUT_IDS, device=device)
    return kwargs


def detect(model, kwargs: dict, top_k: int = 10) -> dict:
    """One forward: logits, boxes, the queries' initial reference points and
    the top-k (query, label) pairs by sigmoid score, as numpy."""
    with torch.no_grad():
        out = model(**kwargs)
    logits = out.logits[0].float().cpu().numpy()        # [N, K]
    scores = 1.0 / (1.0 + np.exp(-logits))
    flat = scores.ravel()
    order = np.argsort(-flat, kind="stable")[:top_k]
    k = logits.shape[1]
    return {"logits": logits,
            "boxes": out.pred_boxes[0].float().cpu().numpy(),  # [N, 4]
            "refs": out.init_reference_points[0].float().cpu().numpy(),
            "top_scores": flat[order], "top_queries": order // k,
            "top_labels": order % k}


def _same_proposal(stock: dict, ours: dict, tol: float = 1e-5):
    """The query slots that start from the same initial reference point in
    both runs (a bool mask), or None when the runs selected different sets
    of reference points."""
    a, b = stock["refs"], ours["refs"]
    same = np.abs(a - b).max(-1) <= tol
    close = np.abs(a[:, None, :] - b[None, :, :]).max(-1) <= tol
    if not (close.any(0).all() and close.any(1).all()):
        return None
    return same


def _timed(model, kwargs, device, top_k, requests):
    """A warm-up forward, then ``requests`` timed ones: the last's
    detections, the mean ms a request and K1's launches a forward."""
    detect(model, kwargs, top_k)
    times, launched = [], []
    for _ in range(requests):
        before = cuda_fwd.LAUNCHES
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        det = detect(model, kwargs, top_k)  # reads the result back
        times.append((time.perf_counter() - t0) * 1e3)
        launched.append(cuda_fwd.LAUNCHES - before)
    if len(set(launched)) != 1:
        raise RuntimeError(f"K1 launches differ between forwards: "
                           f"{launched}")
    return det, sum(times) / len(times), launched[0]


def run_parity(model_name: str = "deformable-detr", size: str = "small",
               device="cuda", seed: int = 0, top_k: int = 10,
               requests: int = 3) -> dict:
    """Stock against patched on one request; returns the record (JSON-able)
    that :func:`main` writes.  ``requests`` timed forwards a side, after a
    warm-up."""
    if model_name not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {model_name!r}")
    device = torch.device(device)
    build = build_grounding_dino if model_name == "grounding-dino" else (
        build_model)
    model = build(size=size, seed=seed).to(device)
    kwargs = model_inputs(model_name, size, seed, device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        stock, stock_ms, _ = _timed(model, kwargs, device, top_k, requests)
        with patched(model):
            ours, ours_ms, k1 = _timed(model, kwargs, device, top_k,
                                       requests)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    # the slots that start from another proposal (a near-tie in a
    # two-stage model's top-k) are left out of the comparison, and counted
    same = _same_proposal(stock, ours)
    if same is None:
        raise RuntimeError("the two runs selected different proposals")
    every_slot = float(np.abs(stock["boxes"] - ours["boxes"]).max())

    # Grounding DINO's text head emits -inf logits at masked text
    # positions by design: compare the finite entries, and require the
    # finiteness pattern itself to match (sigmoid(-inf) = 0 keeps the
    # ranking well defined either way)
    fin_s, fin_p = (np.isfinite(d["logits"][same]) for d in (stock, ours))
    if not np.array_equal(fin_s, fin_p):
        raise RuntimeError("the finite-logit masks diverged")
    same_rank = bool(
        np.array_equal(stock["top_queries"], ours["top_queries"])
        and np.array_equal(stock["top_labels"], ours["top_labels"]))
    name = type(model).__name__
    return {
        "model": f"hf {name} ({size} config, random init, seed {seed})",
        "size": size,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "image": list(IMAGE[size]),
        "num_queries": int(stock["logits"].shape[0]),
        "k1_launches_per_forward": k1,
        "max_abs_logits_diff": float(np.abs(
            stock["logits"][same][fin_s] - ours["logits"][same][fin_p]).max()),
        "max_abs_boxes_diff": float(np.abs(stock["boxes"][same]
                                           - ours["boxes"][same]).max()),
        "slots_with_another_proposal": int((~same).sum()),
        "max_abs_boxes_diff_every_slot": every_slot,
        "topk_detections_identical": same_rank,
        "max_abs_topk_score_diff": float(np.abs(
            stock["top_scores"] - ours["top_scores"]).max()),
        "stock_ms": stock_ms,
        "patched_ms": ours_ms,
        "top_labels": [int(x) for x in stock["top_labels"]],
        "top_queries": [int(x) for x in stock["top_queries"]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m msda_tpu_torch.detection_parity",
        description="HF Deformable DETR and Grounding DINO, stock against "
                    "patched with this port's op.")
    ap.add_argument("--model", nargs="+", choices=MODELS,
                    default=list(MODELS))
    ap.add_argument("--size", choices=("small", "full"), default="small")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    results, failed = {}, []
    for name in args.model:
        res = run_parity(name, args.size, args.device, args.seed)
        path = os.path.join(args.out_dir, f"{name}-{args.size}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        print(json.dumps(res), flush=True)
        if not res["topk_detections_identical"]:
            failed.append(f"{name}: the top-10 detections differ")
        if not res["max_abs_boxes_diff"] < BOXES_TOL:
            failed.append(f"{name}: boxes differ by "
                          f"{res['max_abs_boxes_diff']:.3e}")
        results[name] = res
    if failed:
        raise SystemExit("PARITY FAILED: " + "; ".join(failed))
    print(f"PARITY OK -> {args.out_dir}", flush=True)
    return results


if __name__ == "__main__":
    main()
