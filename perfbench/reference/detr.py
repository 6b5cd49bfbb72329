"""The Deformable DETR forward (single stage, iterative box refinement) in
plain PyTorch, from a weight dict under the detector's ``state_dict``
names: the benchmark's reference for the detector.

It follows arXiv:2010.04159 with the departures that the configuration
file lists (``configs/ddetr-refine.json``): post-norm layers with
LayerNorm eps 1e-6, the level embedding added to the projected features,
encoder offsets divided by each level's (h, w) in (x, y) order, decoder
self-attention over content queries, learned 4-d reference boxes refined
layer by layer, one linear box head a layer.

``rnd`` is applied wherever a half-precision program would round (every
dense layer's input, weights and output, the norms' outputs, the MSDA
values and output): the identity for the f32 reference, a lower precision
for the controls (``fp8``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .msda import msda

LN_EPS = 1e-6


def identity(x):
    return x


def fp8(x):
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at e4m3's largest finite value, 448), back in f32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _dense(W, name, x, rnd):
    return rnd(F.linear(rnd(x), rnd(W[f"{name}.weight"]),
                        rnd(W[f"{name}.bias"])))


def _head(W, name, x):
    """A prediction head: f32 whatever the stack's precision."""
    return F.linear(x, W[f"{name}.weight"], W[f"{name}.bias"])


def _norm(W, name, x, rnd):
    return rnd(F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"],
                            W[f"{name}.bias"], LN_EPS))


def _ffn(W, name, x, rnd):
    y = _dense(W, f"{name}.dense_1",
               torch.relu(_dense(W, f"{name}.dense_0", x, rnd)), rnd)
    return _norm(W, f"{name}.norm_0", x + y, rnd)


def _inv_sigmoid(p, eps=1e-5):
    return torch.log(p / (1.0 - p + eps) + eps)


def _attention(W, name, cfg, img, shapes, queries, refs, rnd):
    """The deformable attention module: offsets and weights from the
    queries, values from the pyramid, the op, the output projection."""
    B, I, _ = img.shape  # noqa: E741
    N = queries.shape[1]
    H, L, P = cfg["num_heads"], cfg["num_levels"], cfg["num_points"]
    q = _dense(W, f"{name}.query_input_proj", queries, rnd).float()
    q = q.view(B, N, H, L, P, 3)
    offsets = q[..., :2]
    wts = torch.softmax(q[..., 2].reshape(B, N, H, L * P), -1).view(
        B, N, H, L, P)
    values = _dense(W, f"{name}.img_input_proj", img, rnd).view(B, I, H, -1)
    if refs.shape[-1] == 2:
        hw = torch.tensor(shapes, dtype=torch.float32, device=img.device)
        pts = refs[:, :, None, None, None, :] + offsets / hw[:, None, :]
    else:
        pts = (refs[:, :, None, None, None, :2]
               + offsets * refs[:, :, None, None, None, 2:] / (2 * P))
    out = rnd(msda(values, shapes, pts, wts, cfg["padding_mode"],
                   cfg["align_corners"]))
    return _dense(W, f"{name}.query_output_proj", out.reshape(B, N, -1), rnd)


def _self_attention(W, name, cfg, x, rnd):
    B, N, D = x.shape
    H = cfg["num_heads"]

    def heads(t):
        return t.view(B, N, H, D // H).transpose(1, 2)

    q = rnd(heads(_dense(W, f"{name}.query", x, rnd)) / math.sqrt(D // H))
    k = heads(_dense(W, f"{name}.key", x, rnd))
    v = heads(_dense(W, f"{name}.value", x, rnd))
    a = rnd(torch.softmax(rnd(q @ k.transpose(-1, -2)), -1))
    y = rnd(a @ v).transpose(1, 2).reshape(B, N, D)
    return _dense(W, f"{name}.out", y, rnd)


def encoder_points(shapes, device) -> torch.Tensor:
    """Normalized (x, y) centre of every pyramid pixel: ``[I, 2]``."""
    out = []
    for h, w in shapes:
        ys = (torch.arange(h, device=device, dtype=torch.float64) + 0.5) / h
        xs = (torch.arange(w, device=device, dtype=torch.float64) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([xx, yy], -1).reshape(-1, 2))
    return torch.cat(out).float()


def forward(W: dict, cfg: dict, pyramid, rnd=identity, remat=False) -> dict:
    """The detector on ``pyramid`` (per level ``[B, h, w, C]``):
    ``{"logits" [B, Q, K], "boxes" [B, Q, 4] cxcywh, "aux": [...]}``.
    ``remat`` recomputes each encoder layer in the backward (to fit a
    training step's autograd)."""
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

    queries = rnd(W["query_embedding"][None].expand(B, -1, -1))
    boxes = torch.sigmoid(W["reference_box_logits"])[None].expand(B, -1, -1)
    aux = []
    refine = cfg["num_decoder_layers"] - 1 if cfg["with_box_refinement"] else 0
    for i in range(cfg["num_decoder_layers"]):
        name = f"decoder_layers.{i}"
        x = _norm(W, f"{name}.norm_0",
                  queries + _self_attention(W, f"{name}.self_attn", cfg,
                                            queries, rnd), rnd)
        y = _attention(W, f"{name}.msda", cfg, feats, shapes, x, boxes, rnd)
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
                                  + _head(W, "box_head", queries.float()))}
    if cfg["with_box_refinement"]:
        out["aux"] = aux
    return out
