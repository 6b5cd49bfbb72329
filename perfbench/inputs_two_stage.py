"""The weights of the published two-stage detector
(``DeformableDetr(two_stage="published")``), made from the seed on the run's
device: those of ``inputs.detector_weights`` (the same draws, so that the
layers the two configurations share start from the same weights at the same
seed), without the learned query embedding and reference boxes, which this
form does not have, and the proposal stage's own, from a draw of their
own."""

from __future__ import annotations

import math

import torch

from . import inputs

#: what the published form's ``state_dict`` lacks of ``inputs.detector_spec``
ABSENT = ("query_embedding", "reference_box_logits")


def proposal_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of the proposal stage's parameters, the kinds
    of ``inputs.detector_spec``.  As the official model initialises them:
    the two projections Xavier-uniform (``DeformableTransformer.
    _reset_parameters`` resets only matrices), ``pos_trans`` with
    ``nn.Linear``'s default bias, the encoder's class head as the
    decoder's (its default weight, the focal prior bias), and its box
    head, which the official zeroes, ``moved`` as the decoder's box heads
    are.  But ``enc_output``'s bias starts at zero, where the official
    keeps the default: the tokens of invalid anchors enter the proposal
    heads as zeros, so they all score ``enc_class_head(LayerNorm(bias))``,
    and with a default bias that one logit tops every valid token's on
    about one seed in 40 (3000000039): the decoder then starts from one
    invalid proposal repeated 300 times, a step whose zero gradients
    Adam turns into full-size steps of rounding's sign.  A zero bias puts
    that logit at the prior, the valid tokens' mean."""
    D, K = cfg["emb_dim"], cfg["num_classes"]
    return [("enc_output.weight", (D, D), "xavier"),
            ("enc_output.bias", (D,), "zero"),
            ("enc_output_norm.weight", (D,), "one"),
            ("enc_output_norm.bias", (D,), "zero"),
            ("enc_class_head.weight", (K, D), "fan_in"),
            ("enc_class_head.bias", (K,), "prior"),
            ("enc_box_head.weight", (4, D), "moved"),
            ("enc_box_head.bias", (4,), "zero"),
            ("pos_trans.weight", (2 * D, 2 * D), "xavier"),
            ("pos_trans.bias", (2 * D,), "fan_in"),
            ("pos_trans_norm.weight", (2 * D,), "one"),
            ("pos_trans_norm.bias", (2 * D,), "zero")]


def detector_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """Every parameter of the published two-stage detector."""
    return [e for e in inputs.detector_spec(cfg) if e[0] not in ABSENT] + \
        proposal_spec(cfg)


def detector_weights(cfg: dict, seed: int, device) -> dict:
    """The published two-stage detector's f32 weights from ``seed``."""
    weights = inputs.detector_weights(cfg, seed, device)
    for name in ABSENT:
        del weights[name]
    spec = proposal_spec(cfg)
    g = inputs.generator(seed, device, "weights", "proposals")
    uniform = torch.rand(sum(math.prod(s) for _, s, k in spec
                             if k in ("xavier", "fan_in", "moved")),
                         generator=g, device=device) * 2 - 1
    prior = -math.log((1 - 0.01) / 0.01)
    used, fan_in = 0, {}
    for name, shape, kind in spec:
        layer = name.rsplit(".", 1)[0]
        if name.endswith(".weight") and len(shape) == 2:
            fan_in[layer] = shape[1]
        if kind in ("xavier", "fan_in", "moved"):
            n = math.prod(shape)
            scale = (math.sqrt(6.0 / sum(shape)) if kind == "xavier" else
                     (inputs.MOVED if kind == "moved" else 1.0)
                     / math.sqrt(fan_in[layer]))
            t = uniform[used:used + n].view(shape) * scale
            used += n
        elif kind in ("zero", "one"):
            t = torch.full(shape, float(kind == "one"), device=device)
        else:  # prior
            t = torch.full(shape, prior, device=device)
        weights[name] = t.contiguous()
    return weights
