"""DINO (arXiv:2203.03605) in its 5-scale form, trained, in plain PyTorch,
from a weight dict under the detector's ``state_dict`` names: the
benchmark's reference for the DINO detector.

It follows the official ``DINO.forward``, ``prepare_for_cdn``,
``dn_post_process`` and ``DeformableTransformer.forward`` (its
``two_stage_type="standard"`` branch) with the departures that
``configs/dino-5scale.json`` lists; the encoder and the decoder layers'
sublayers are ``reference.detr``'s and ``reference.detr_two_stage``'s.

- The proposal stage: the tokens zeroed where their anchor is invalid,
  through ``enc_output`` and ``enc_output_norm``; the encoder's class head
  and 3-layer box MLP (added to the anchor's logits) over every token; the
  ``num_queries`` tokens of the highest logit of any class, or those
  ``top_idx`` names (mixed query selection).  Their detached box logits
  are the first references, the learned ``query_embedding`` the content
  queries, and their heads, undetached, the ``interm`` outputs.
- Contrastive denoising (``denoising_queries``): DINO's rule applied to the
  draws it is given (the program's), one image at a time: ``2 * number //
  (2 m)`` groups of a positive and a negative copy of the image's real
  targets, labels flipped where a draw falls below half the noise ratio,
  corners moved by ``u * sign * (w / 2, h / 2) * scale`` (u in [0, 1) for
  positives, [1, 2) for negatives) and clamped, box logits by DINO's
  clamped inverse sigmoid; the attention mask built by the official loop.
- The decoder: each layer's ``query_pos`` from ``ref_point_head`` over the
  sine embedding of its reference box in (y, x, w, h) order; the masked
  self-attention; the deformable attention around the box; the reference
  updated by the shared box MLP on the layer's output, detached for the
  next layer; the prediction from ``decoder_norm``'s output by the shared
  class head and box MLP, the box added to the logits of the layer
  before's updated box, undetached (look forward twice).

The keyword faults put a program's fault in its place for the checks'
calibration: ``masked=False`` drops the group mask, ``look_twice=False``
detaches the box each prediction is added to, ``noise=False`` builds the
DN queries without noise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .detr import (_attention, _dense, _ffn, _head, _inv_sigmoid, _norm,
                   identity)
from .detr_two_stage import _encode, anchor_logits


def box_sine(boxes: torch.Tensor, width: int) -> torch.Tensor:
    """The official ``gen_sineembed_for_position`` of boxes ``[..., 4]``
    (cxcywh in [0, 1]): for each of y, x, w, h in that order, F = width / 4
    features 10000^(2 floor(i / 2) / F) apart, sine at even i, cosine at
    odd i, interleaved."""
    F_ = width // 4
    dim_t = torch.arange(F_, dtype=torch.float32, device=boxes.device)
    dim_t = 10000 ** (2 * (dim_t // 2) / F_)
    out = []
    for c in (1, 0, 2, 3):
        p = boxes[..., c, None] * (2 * math.pi) / dim_t
        out.append(torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()),
                               -1).flatten(-2))
    return torch.cat(out, -1)


def _mlp(W, name, x, layers, rnd=None):
    """An MLP of ``layers`` linear layers, ReLU between: a head (f32) when
    ``rnd`` is None, else dense layers rounded by ``rnd``."""
    for i in range(layers):
        if i:
            x = torch.relu(x)
        x = (_head(W, f"{name}.layers.{i}", x) if rnd is None
             else _dense(W, f"{name}.layers.{i}", x, rnd))
    return x


def _self_attention(W, name, cfg, x, pos, mask, rnd):
    B, N, D = x.shape
    H = cfg["num_heads"]

    def heads(t):
        return t.view(B, N, H, D // H).transpose(1, 2)

    q = rnd(heads(_dense(W, f"{name}.query", x + pos, rnd))
            / math.sqrt(D // H))
    k = heads(_dense(W, f"{name}.key", x + pos, rnd))
    v = heads(_dense(W, f"{name}.value", x, rnd))
    s = rnd(q @ k.transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(mask, float("-inf"))
    a = rnd(torch.softmax(s, -1))
    y = rnd(a @ v).transpose(1, 2).reshape(B, N, D)
    return _dense(W, f"{name}.out", y, rnd)


def dn_groups(m: int, number: int) -> int:
    """DINO's group count for a batch whose largest count of real targets
    is ``m``."""
    g = number * 2
    if m == 0:
        return 1
    if g >= 100:
        g = g // (m * 2)
    elif g < 1:
        g = 1
    return max(g, 1)


def _inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def attention_mask(m: int, groups: int, Q: int, device) -> torch.Tensor:
    """The official loop's mask: True where a query may not attend."""
    pad = 2 * groups * m
    size = pad + Q
    mask = torch.zeros((size, size), dtype=torch.bool, device=device)
    mask[pad:, :pad] = True
    for i in range(groups):
        rows = slice(2 * m * i, 2 * m * (i + 1))
        if i == 0:
            mask[rows, 2 * m * (i + 1):pad] = True
        if i == groups - 1:
            mask[rows, :2 * m * i] = True
        else:
            mask[rows, 2 * m * (i + 1):pad] = True
            mask[rows, :2 * m * i] = True
    return mask


def denoising_queries(W, cfg, targets, draws, noise=True):
    """``(queries [B, pad, D], box logits [B, pad, 4], m, groups)`` from the
    batch's targets and ``draws`` (``[B, 2 groups, m]`` a copy and slot:
    ``flip``, ``label``, ``sign`` and ``part`` by corner)."""
    dn = cfg["dn"]
    B, copies, m = draws["flip"].shape
    groups, D = copies // 2, cfg["emb_dim"]
    table = W["label_enc.weight"]
    queries = torch.zeros((B, copies * m, D), device=table.device)
    unact = torch.zeros((B, copies * m, 4), device=table.device)
    for b in range(B):
        real = [j for j, on in enumerate(targets["mask"][b].tolist()) if on]
        n = len(real)
        if not n:
            continue
        labels = targets["labels"][b, real].long()[None].expand(copies, n)
        boxes = targets["boxes"][b, real][None].expand(copies, n, 4)
        if noise and dn["label_noise_ratio"] > 0:
            flip = draws["flip"][b, :, :n] < dn["label_noise_ratio"] * 0.5
            labels = torch.where(flip, draws["label"][b, :, :n], labels)
        if noise and dn["box_noise_scale"] > 0:
            corners = torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                                 boxes[..., :2] + boxes[..., 2:] / 2], -1)
            diff = torch.cat([boxes[..., 2:] / 2, boxes[..., 2:] / 2], -1)
            part = draws["part"][b, :, :n].clone()
            part[1::2] += 1.0  # the negative copies
            part = part * draws["sign"][b, :, :n]
            corners = corners + part * diff * dn["box_noise_scale"]
            corners = corners.clamp(min=0.0, max=1.0)
            boxes = torch.cat([(corners[..., :2] + corners[..., 2:]) / 2,
                               corners[..., 2:] - corners[..., :2]], -1)
        slots = (torch.arange(copies, device=table.device)[:, None] * m
                 + torch.arange(n, device=table.device)[None]).reshape(-1)
        queries[b, slots] = table[labels.reshape(-1)]
        unact[b, slots] = _inverse_sigmoid(boxes.reshape(-1, 4))
    return queries, unact, m, groups


def forward(W: dict, cfg: dict, pyramid, rnd=identity, remat=False,
            top_idx=None, targets=None, draws=None, masked=True,
            look_twice=True, noise=True) -> dict:
    """The detector on ``pyramid`` (per level ``[B, h, w, C]``): ``{"logits"
    [B, Q, K], "boxes" [B, Q, 4], "aux": [...], "interm": {...},
    "scores" [B, I] (each token's highest class logit), "enc_logits" [B, I,
    K], "top_idx" [B, Q]}``, and with ``targets`` and ``draws`` the DN
    queries' ``"dn": {"logits", "boxes", "aux"}`` and ``"dn_meta"``.
    ``top_idx`` decodes from those tokens instead of the top ``Q``."""
    D, Q = cfg["emb_dim"], cfg["num_queries"]
    feats, shapes = _encode(W, cfg, pyramid, rnd, remat)
    B = feats.shape[0]
    anchors = anchor_logits(shapes, feats.device)
    memory = torch.where(anchors.isfinite().all(-1, keepdim=True), feats,
                         torch.zeros_like(feats))
    memory = _norm(W, "enc_output_norm", _dense(W, "enc_output", memory, rnd),
                   rnd).float()
    enc_logits = _head(W, "enc_class_head", memory)
    enc_unact = _mlp(W, "enc_box_head", memory, 3) + anchors
    scores = enc_logits.max(-1).values
    if top_idx is None:
        top_idx = torch.topk(scores, Q, dim=1).indices
    K = enc_logits.shape[-1]
    top = torch.gather(enc_unact, 1, top_idx[..., None].expand(-1, -1, 4))
    interm = {"logits": torch.gather(enc_logits, 1,
                                     top_idx[..., None].expand(-1, -1, K)),
              "boxes": torch.sigmoid(top)}
    queries = rnd(W["query_embedding"])[None].expand(B, -1, -1)
    unact = top.detach()
    mask, pad, meta = None, 0, None
    if draws is not None:
        dq, du, m, groups = denoising_queries(W, cfg, targets, draws, noise)
        pad = dq.shape[1]
        queries = torch.cat([rnd(dq), queries], 1)
        unact = torch.cat([du, unact], 1)
        if masked:
            mask = attention_mask(m, groups, Q, feats.device)
        meta = {"max_targets": m, "groups": groups, "pad": pad}

    refs = torch.sigmoid(unact)
    before = refs
    preds = []
    n = cfg["num_decoder_layers"]
    for i in range(n):
        name = f"decoder_layers.{i}"
        pos = _mlp(W, "ref_point_head", box_sine(refs, 2 * D), 2, rnd)
        x = _norm(W, f"{name}.norm_0",
                  queries + _self_attention(W, f"{name}.self_attn", cfg,
                                            queries, pos, mask, rnd), rnd)
        y = _attention(W, f"{name}.msda", cfg, feats, shapes, x + pos, refs,
                       rnd)
        queries = _ffn(W, f"{name}.ffn", _norm(W, f"{name}.norm_1", x + y,
                                               rnd), rnd)
        hs = _norm(W, "decoder_norm", queries, rnd).float()
        prior = before if look_twice else before.detach()
        preds.append((_head(W, "class_head", hs), torch.sigmoid(
            _mlp(W, "box_head", hs, 3) + _inv_sigmoid(prior))))
        if i + 1 < n:
            before = torch.sigmoid(_mlp(W, "box_head", queries.float(), 3)
                                   + _inv_sigmoid(refs))
            refs = before.detach()

    def part(lo, hi):
        return [{"logits": c[:, lo:hi], "boxes": b[:, lo:hi]}
                for c, b in preds]

    matching = part(pad, None)
    out = dict(matching[-1], aux=matching[:-1], interm=interm,
               scores=scores, enc_logits=enc_logits, top_idx=top_idx)
    if meta is not None:
        dn = part(0, pad)
        out["dn"] = dict(dn[-1], aux=dn[:-1])
        out["dn_meta"] = meta
    return out
