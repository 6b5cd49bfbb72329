"""Two-stage Deformable DETR as published, with iterative box refinement,
in plain PyTorch, from a weight dict under the detector's ``state_dict``
names: the benchmark's reference for the two-stage detector.

It follows arXiv:2010.04159 §4.2 and App. A.4 and the official
``DeformableTransformer.forward`` (its ``two_stage`` branch,
``gen_encoder_output_proposals``, ``get_proposal_pos_embed``) with the
departures that ``configs/ddetr-2stage-refine.json`` lists; the encoder,
the decoder layers' sublayers and the heads are ``reference.detr``'s.

The proposal stage: each pyramid pixel's anchor (its centre, side 0.05 *
2^level) in logit space, +inf where a coordinate lies outside (0.01,
0.99), its token zeroed there; the tokens through ``enc_output`` and
``enc_output_norm``; the encoder's class head over every token and its box
head added to the anchor's logits; the ``num_queries`` tokens of the
highest logit 0, or those ``top_idx`` names; their detached box logits'
sine embedding through ``pos_trans`` and ``pos_trans_norm``, split into
``query_pos`` and the content queries, and their sigmoids the first
reference boxes.  Each decoder layer's self-attention takes queries and
keys from ``x + query_pos`` and values from ``x``; its deformable
attention the query ``x + query_pos``.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .detr import (_attention, _dense, _ffn, _head, _inv_sigmoid, _norm,
                   encoder_points, identity)


def anchor_logits(shapes, device) -> torch.Tensor:
    """``[I, 4]``: each pixel's anchor box (cx, cy, w, h) in logit space,
    +inf in all four where a coordinate lies outside (0.01, 0.99); worked
    out in f64, returned in f32."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        ys = (torch.arange(h, device=device, dtype=torch.float64) + 0.5) / h
        xs = (torch.arange(w, device=device, dtype=torch.float64) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        side = torch.full_like(xx, 0.05 * 2 ** lvl)
        out.append(torch.stack([xx, yy, side, side], -1).reshape(-1, 4))
    a = torch.cat(out)
    valid = ((a > 0.01) & (a < 0.99)).all(-1, keepdim=True)
    return torch.where(valid, torch.log(a / (1 - a)),
                       torch.full_like(a, math.inf)).float()


def pos_embed(boxes: torch.Tensor, width: int) -> torch.Tensor:
    """The sine embedding of box logits ``[..., 4]``: for each coordinate c
    and i < F = width / 4, with a = sigmoid(c) * 2 pi / 10000^(2 floor(i /
    2) / F), sin(a) at an even i and cos(a) at an odd one: ``[..., width]``."""
    F = width // 4
    i = torch.arange(F, device=boxes.device, dtype=torch.float32)
    a = (torch.sigmoid(boxes)[..., None] * (2 * math.pi)
         / 10000.0 ** (2 * torch.floor(i / 2) / F))
    return torch.where(i % 2 == 0, torch.sin(a), torch.cos(a)).flatten(-2)


def _self_attention(W, name, cfg, x, pos, rnd):
    B, N, D = x.shape
    H = cfg["num_heads"]

    def heads(t):
        return t.view(B, N, H, D // H).transpose(1, 2)

    q = rnd(heads(_dense(W, f"{name}.query", x + pos, rnd))
            / math.sqrt(D // H))
    k = heads(_dense(W, f"{name}.key", x + pos, rnd))
    v = heads(_dense(W, f"{name}.value", x, rnd))
    a = rnd(torch.softmax(rnd(q @ k.transpose(-1, -2)), -1))
    y = rnd(a @ v).transpose(1, 2).reshape(B, N, D)
    return _dense(W, f"{name}.out", y, rnd)


def _encode(W, cfg, pyramid, rnd, remat):
    B = pyramid[0].shape[0]
    shapes = tuple(tuple(f.shape[1:3]) for f in pyramid)
    feats = torch.cat([
        _dense(W, f"input_proj.{lvl}", f, rnd).reshape(B, -1, cfg["emb_dim"])
        + rnd(W["level_embedding"][lvl]) for lvl, f in enumerate(pyramid)], 1)
    feats = rnd(feats)
    I = feats.shape[1]  # noqa: E741
    refs = encoder_points(shapes, feats.device)[None].expand(B, I, 2)

    def encoder_layer(i, x):
        name = f"encoder_layers.{i}"
        y = _attention(W, f"{name}.msda", cfg, x, shapes, x, refs, rnd)
        return _ffn(W, f"{name}.ffn", _norm(W, f"{name}.norm_0", x + y, rnd),
                    rnd)

    for i in range(cfg["num_encoder_layers"]):
        if remat and torch.is_grad_enabled():
            feats = checkpoint(encoder_layer, i, feats, use_reentrant=False)
        else:
            feats = encoder_layer(i, feats)
    return feats, shapes


def proposals(W, cfg, feats, shapes, rnd=identity, masked=True) -> dict:
    """The proposal heads over every token: ``{"logits" [B, I, K],
    "unact" [B, I, 4]}`` (box logits, +inf where the anchor is invalid).
    ``masked=False`` leaves the invalid tokens as they are (a fault)."""
    anchors = anchor_logits(shapes, feats.device)
    memory = feats
    if masked:
        memory = torch.where(anchors.isfinite().all(-1, keepdim=True),
                             feats, torch.zeros_like(feats))
    memory = _norm(W, "enc_output_norm",
                   _dense(W, "enc_output", memory, rnd), rnd).float()
    return {"logits": _head(W, "enc_class_head", memory),
            "unact": _head(W, "enc_box_head", memory) + anchors}


def forward(W: dict, cfg: dict, pyramid, rnd=identity, remat=False,
            top_idx=None) -> dict:
    """The detector on ``pyramid`` (per level ``[B, h, w, C]``):
    ``{"logits" [B, Q, K], "boxes" [B, Q, 4] cxcywh, "aux": [...], "enc":
    {"logits" [B, I, K], "boxes" [B, I, 4], "top_idx" [B, Q]}}``.
    ``top_idx`` (``[B, Q]``) decodes from those proposals instead of the
    top ``Q`` by logit 0.  ``remat`` recomputes each encoder layer in the
    backward."""
    D, Q = cfg["emb_dim"], cfg["num_queries"]
    feats, shapes = _encode(W, cfg, pyramid, rnd, remat)
    enc = proposals(W, cfg, feats, shapes, rnd)
    if top_idx is None:
        top_idx = torch.topk(enc["logits"][..., 0], Q, dim=1).indices
    top = torch.gather(enc["unact"], 1,
                       top_idx[..., None].expand(-1, -1, 4)).detach()
    pos = _norm(W, "pos_trans_norm",
                _dense(W, "pos_trans", pos_embed(top, 2 * D), rnd), rnd)
    query_pos, queries = pos[..., :D], pos[..., D:]
    boxes = torch.sigmoid(top)

    aux = []
    refine = cfg["num_decoder_layers"] - 1 if cfg["with_box_refinement"] else 0
    for i in range(cfg["num_decoder_layers"]):
        name = f"decoder_layers.{i}"
        x = _norm(W, f"{name}.norm_0",
                  queries + _self_attention(W, f"{name}.self_attn", cfg,
                                            queries, query_pos, rnd), rnd)
        y = _attention(W, f"{name}.msda", cfg, feats, shapes, x + query_pos,
                       boxes, rnd)
        queries = _ffn(W, f"{name}.ffn",
                       _norm(W, f"{name}.norm_1", x + y, rnd), rnd)
        if i < refine:
            refined = torch.sigmoid(
                _inv_sigmoid(boxes)
                + _head(W, f"box_refine.{i}", queries.float()))
            aux.append({"logits": _head(W, f"aux_class.{i}", queries.float()),
                        "boxes": refined})
            boxes = refined.detach()
    out = {"logits": _head(W, "class_head", queries.float()),
           "boxes": torch.sigmoid(_inv_sigmoid(boxes)
                                  + _head(W, "box_head", queries.float())),
           "enc": {"logits": enc["logits"],
                   "boxes": torch.sigmoid(enc["unact"]), "top_idx": top_idx}}
    if cfg["with_box_refinement"]:
        out["aux"] = aux
    return out
