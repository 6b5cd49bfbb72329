"""How the drivers reach the system under test, ``msda_tpu_torch``,
through its public entry points only."""

from __future__ import annotations

import torch


def detector(cfg: dict, weights: dict, device, compute_dtype=None):
    """``msda_tpu_torch.models.DeformableDetr`` built as the configuration
    states, with ``weights`` loaded (every parameter, strictly)."""
    from msda_tpu_torch.models import DeformableDetr

    model = DeformableDetr(
        num_classes=cfg["num_classes"], in_channels=tuple(cfg["in_channels"]),
        emb_dim=cfg["emb_dim"], num_heads=cfg["num_heads"],
        num_points=cfg["num_points"], num_queries=cfg["num_queries"],
        num_encoder_layers=cfg["num_encoder_layers"],
        num_decoder_layers=cfg["num_decoder_layers"], ffn_dim=cfg["ffn_dim"],
        with_box_refinement=cfg["with_box_refinement"],
        two_stage=cfg["two_stage"], compute_dtype=compute_dtype,
        device=device)
    model.load_state_dict(weights, strict=True)
    return model


def shapes_of(pyramid) -> tuple:
    """The level shapes of a pyramid's tensors ``[B, h, w, C]``."""
    return tuple((int(f.shape[1]), int(f.shape[2])) for f in pyramid)


def dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
