"""Deformable-DETR detector built on the MSDA op (PyTorch).

The counterpart of ``msda_tpu/models/detr.py``: a deformable encoder over
the flattened feature pyramid, a decoder with learned queries, and detection
heads, the architecture of arXiv:2010.04159 §4 with both paper variants
(iterative box refinement and two-stage).  ``postprocess`` decodes the
outputs into ranked detections.  Parameters are made with PyTorch's default
initialisation; :func:`init_parameters` re-draws them from a
``torch.Generator``, and ``models.convert.state_dict_from_flax`` loads the
JAX model's parameters.

``remat=True`` recomputes each encoder and decoder layer in the backward
instead of keeping its activations (``torch.utils.checkpoint``, the
counterpart of the JAX model's ``nn.remat``).

``mesh`` (``parallel.make_mesh``) runs the model on a device mesh: each
rank takes its dp block of the batch, and every deformable attention
module runs its share of the queries (sp) and heads (tp); the rest of the
model is replicated.  ``parallel.make_train_step(mesh=...)`` trains it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import cuda_norm, level_shapes, library
from ..parallel.boxes import box_cxcywh_to_xyxy
from ..utils.profile import annotate
from .attention import Dense, MultiscaleDeformableAttention, device_constant

__all__ = [
    "make_encoder_reference_points",
    "make_proposal_anchors",
    "LayerNorm",
    "MultiHeadSelfAttention",
    "DeformableEncoderLayer",
    "DeformableDecoderLayer",
    "DeformableDetr",
    "init_parameters",
    "postprocess",
]

# flax's nn.LayerNorm default; torch's is 1e-5
LAYER_NORM_EPS = 1e-6


def _pixel_centers(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    ys, xs = np.meshgrid(
        (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij"
    )
    return xs, ys


def make_proposal_anchors(img_shapes, base_scale: float = 0.05,
                          device=None) -> torch.Tensor:
    """Per-pixel anchor boxes for two-stage proposal generation: [I, 4].

    Each pyramid pixel anchors a box at its own center with a per-level
    size of ``base_scale * 2^level`` (Deformable DETR §A.4).  Normalized
    cxcywh, f32.
    """
    anchors = []
    for lvl, (h, w) in enumerate(level_shapes(img_shapes)):
        xs, ys = _pixel_centers(h, w)
        wh = np.full_like(xs, min(base_scale * (2 ** lvl), 0.9))
        anchors.append(np.stack([xs, ys, wh, wh], axis=-1).reshape(-1, 4))
    return _on_device(np.concatenate(anchors, axis=0), device)


def make_encoder_reference_points(img_shapes, device=None) -> torch.Tensor:
    """Normalized (x, y) centers of every pyramid pixel: [I, 2], f32.

    Encoder self-attention uses each pixel as a query whose reference point
    is its own location (Deformable DETR §A.2).
    """
    refs = []
    for h, w in level_shapes(img_shapes):
        xs, ys = _pixel_centers(h, w)
        refs.append(np.stack([xs, ys], axis=-1).reshape(-1, 2))
    return _on_device(np.concatenate(refs, axis=0), device)


def _on_device(array: np.ndarray, device) -> torch.Tensor:
    """``array`` as an f32 tensor made on ``device`` from a list: a traced
    program (``torch.export``) keeps such a tensor as a constant on the
    device, where it would copy a host tensor to the device at every
    call."""
    return torch.tensor(array.tolist(), dtype=torch.float32, device=device)


def _inv_sigmoid(p: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # the JAX model's form, not torch.logit
    return torch.log(p / (1.0 - p + eps) + eps)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax ``nn.LayerNorm``'s eps (1e-6) and dtype
    policy: statistics in at least f32, output in ``compute_dtype`` (or the
    promoted input/parameter dtype).

    ``forward(x, residual)`` normalizes the residual sum ``x + residual``.
    Where the activations are CUDA tensors of a half type that the output
    keeps, of a width the kernel takes, and autograd records nothing, the
    sum and the norm are one hand-written kernel
    (``torch.ops.msda_tpu_torch.add_layer_norm``, ``csrc/msda_norm.cu``):
    the same rounding of the sum, f32 statistics, the same output dtype.
    Every other call (the CPU, f32, training) adds and normalizes as four
    PyTorch calls: the add, a cast to f32, ``F.layer_norm``, a cast back."""

    def __init__(self, dim: int, compute_dtype: torch.dtype | None = None,
                 device=None):
        super().__init__(dim, eps=LAYER_NORM_EPS, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        out_dtype = self.compute_dtype or torch.promote_types(
            x.dtype, self.weight.dtype)
        if residual is not None:
            if self._fused(x, residual, out_dtype):
                return library.add_layer_norm(x, residual, self.weight,
                                              self.bias, self.eps)
            x = x + residual
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        y = nn.functional.layer_norm(
            x.to(stat_dtype), self.normalized_shape,
            self.weight.to(stat_dtype), self.bias.to(stat_dtype), self.eps)
        return y.to(out_dtype)

    def _fused(self, x, residual, out_dtype) -> bool:
        """Whether ``x + residual`` takes the fused kernel."""
        return (x.is_cuda and x.dtype in cuda_norm.DTYPES
                and residual.dtype == x.dtype == out_dtype
                and residual.shape == x.shape
                and residual.device == x.device
                and cuda_norm.supported(x.shape[-1])
                and not (torch.is_grad_enabled() and any(
                    t.requires_grad
                    for t in (x, residual, self.weight, self.bias))))


class _FFN(nn.Module):
    def __init__(self, dim: int, hidden: int, compute_dtype=None, device=None):
        super().__init__()
        self.dense_0 = Dense(dim, hidden, compute_dtype, device)
        self.dense_1 = Dense(hidden, dim, compute_dtype, device)
        self.norm_0 = LayerNorm(dim, compute_dtype, device)

    def forward(self, x):
        y = self.dense_1(torch.relu(self.dense_0(x)))
        return self.norm_0(x, y)


class MultiHeadSelfAttention(nn.Module):
    """Decoder query self-attention, as flax ``MultiHeadDotProductAttention``
    computes it: per-head query/key/value projections, scores scaled by
    ``1/sqrt(head_dim)``, a softmax over keys (in f32), no mask, no dropout,
    and an output projection.  Explicit matmuls, no fused attention kernel.
    """

    def __init__(self, dim: int, num_heads: int, compute_dtype=None,
                 device=None):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(f"dim={dim} is not divisible by "
                             f"num_heads={num_heads}")
        self.num_heads = num_heads
        self.query = Dense(dim, dim, compute_dtype, device)
        self.key = Dense(dim, dim, compute_dtype, device)
        self.value = Dense(dim, dim, compute_dtype, device)
        self.out = Dense(dim, dim, compute_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        Dh = D // H

        def heads(t):  # [B, N, D] -> [B, H, N, Dh]
            return t.reshape(B, N, H, Dh).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(Dh)
        k = heads(self.key(x))
        v = heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2))  # [B, H, N, N]
        weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        y = torch.matmul(weights, v).transpose(1, 2).reshape(B, N, D)
        return self.out(y)


class DeformableEncoderLayer(nn.Module):
    """Pyramid self-attention: every pixel attends deformably to the pyramid."""

    def __init__(self, emb_dim: int, num_levels: int, num_heads: int,
                 num_points: int, ffn_dim: int = 1024, compute_dtype=None,
                 impl: str = "auto", device=None, mesh=None):
        super().__init__()
        self.msda = MultiscaleDeformableAttention(
            emb_dim=emb_dim, hidden_dim=emb_dim, num_levels=num_levels,
            num_heads=num_heads, num_points=num_points,
            padding_mode="border", align_corners=False,
            compute_dtype=compute_dtype, impl=impl, device=device,
            mesh=mesh,
        )
        self.norm_0 = LayerNorm(emb_dim, compute_dtype, device)
        self.ffn = _FFN(emb_dim, ffn_dim, compute_dtype, device)

    def forward(self, feats, img_shapes, reference_points):
        """feats [B, I, D]; reference_points [I, 2] -> [B, I, D]."""
        B, I, _ = feats.shape  # noqa: E741
        refs = reference_points[None].expand(B, I, 2)
        y = self.msda(feats, img_shapes, feats, refs)
        x = self.norm_0(feats, y)
        return self.ffn(x)


class DeformableDecoderLayer(nn.Module):
    """Query self-attention + deformable cross-attention into the pyramid."""

    def __init__(self, emb_dim: int, num_levels: int, num_heads: int,
                 num_points: int, ffn_dim: int = 1024, compute_dtype=None,
                 impl: str = "auto", device=None, mesh=None):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(emb_dim, num_heads,
                                                compute_dtype, device)
        self.norm_0 = LayerNorm(emb_dim, compute_dtype, device)
        self.msda = MultiscaleDeformableAttention(
            emb_dim=emb_dim, hidden_dim=emb_dim, num_levels=num_levels,
            num_heads=num_heads, num_points=num_points,
            padding_mode="border", align_corners=False,
            compute_dtype=compute_dtype, impl=impl, device=device,
            mesh=mesh,
        )
        self.norm_1 = LayerNorm(emb_dim, compute_dtype, device)
        self.ffn = _FFN(emb_dim, ffn_dim, compute_dtype, device)

    def forward(self, queries, feats, img_shapes, reference_points):
        """queries [B, N, D]; feats [B, I, D]; reference_points [B, N, 2|4]."""
        x = self.norm_0(queries, self.self_attn(queries))
        y = self.msda(feats, img_shapes, x, reference_points)
        x = self.norm_1(x, y)
        return self.ffn(x)


class DeformableDetr(nn.Module):
    """Deformable-DETR detector over a multi-scale feature pyramid.

    Consumes per-level backbone features ``[B, h_l, w_l, C_l]`` (channels
    last), runs the deformable encoder/decoder, and emits class logits and
    normalized (cx, cy, w, h) boxes per query, including both paper
    variants:

    * *iterative bounding-box refinement* (``with_box_refinement=True``):
      per-layer box heads refine the references the next decoder layer
      samples around, with per-layer ``aux`` predictions;
    * *two-stage* (``two_stage=True``): every encoder pixel emits a proposal
      (objectness + box on a per-level anchor) and the top ``num_queries``
      proposals seed the decoder's reference boxes and positional content,
      with ``enc`` outputs for proposal supervision.

    ``in_channels`` gives ``C_l`` per level (its length is the number of
    levels).  ``compute_dtype=torch.bfloat16`` runs the transformer stack
    in bf16 with f32 parameters; sampling geometry, reference-box math and
    the prediction heads stay f32.  ``remat=True`` recomputes each encoder
    and decoder layer in the backward instead of keeping its activations
    (while gradients are enabled; the results are the same).  ``mesh``
    runs it on a device mesh (the module docstring).
    """

    def __init__(
        self,
        num_classes: int,
        in_channels: Sequence[int],
        emb_dim: int = 256,
        num_heads: int = 8,
        num_points: int = 4,
        num_queries: int = 100,
        num_encoder_layers: int = 2,
        num_decoder_layers: int = 2,
        ffn_dim: int = 1024,
        with_box_refinement: bool = False,
        two_stage: bool = False,
        remat: bool = False,
        compute_dtype: torch.dtype | None = None,
        impl: str = "auto",
        device=None,
        mesh=None,
    ):
        super().__init__()
        L = len(in_channels)
        self.num_classes = num_classes
        self.emb_dim = emb_dim
        self.num_queries = num_queries
        self.with_box_refinement = with_box_refinement
        self.two_stage = two_stage
        self.remat = remat
        self.compute_dtype = compute_dtype
        # the encoder reference points and proposal anchors by pyramid shapes
        # (attention.device_constant)
        self._constants = {}
        cd = compute_dtype
        layer_args = dict(emb_dim=emb_dim, num_levels=L, num_heads=num_heads,
                          num_points=num_points, ffn_dim=ffn_dim,
                          compute_dtype=cd, impl=impl, device=device,
                          mesh=mesh)

        self.level_embedding = nn.Parameter(
            torch.zeros(L, emb_dim, device=device))
        self.input_proj = nn.ModuleList(
            Dense(c, emb_dim, cd, device) for c in in_channels)
        self.encoder_layers = nn.ModuleList(
            DeformableEncoderLayer(**layer_args)
            for _ in range(num_encoder_layers))
        self.query_embedding = nn.Parameter(
            torch.zeros(num_queries, emb_dim, device=device))
        if two_stage:
            self.enc_objectness = Dense(emb_dim, 1, device=device)
            self.enc_box_head = Dense(emb_dim, 4, device=device)
            self.proposal_pos_proj = Dense(4, emb_dim, cd, device)
        else:
            self.reference_box_logits = nn.Parameter(
                torch.zeros(num_queries, 4, device=device))
        self.decoder_layers = nn.ModuleList(
            DeformableDecoderLayer(**layer_args)
            for _ in range(num_decoder_layers))
        n_refine = num_decoder_layers - 1 if with_box_refinement else 0
        self.box_refine = nn.ModuleList(
            Dense(emb_dim, 4, device=device) for _ in range(n_refine))
        self.aux_class = nn.ModuleList(
            Dense(emb_dim, num_classes, device=device)
            for _ in range(n_refine))
        self.class_head = Dense(emb_dim, num_classes, device=device)
        self.box_head = Dense(emb_dim, 4, device=device)

    def forward(self, pyramid: Sequence[torch.Tensor], img_shapes):
        """pyramid: per-level features [B, h_l, w_l, C_l]; img_shapes [L, 2].

        Returns dict(logits=[B, N, num_classes], boxes=[B, N, 4] in
        normalized cxcywh), plus ``aux`` (box refinement) and ``enc``
        (two-stage).
        """
        shapes = level_shapes(img_shapes)  # once, on the host

        def run(layer, *args):
            if self.remat and torch.is_grad_enabled():
                # the layers draw no random numbers (no dropout), so the
                # RNG state need not be saved; reading it would stop the
                # step's capture as a CUDA graph
                return checkpoint(layer, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return layer(*args)

        with annotate("encoder"):
            feats = self._encode(pyramid, shapes, run)
        with annotate("decoder"):
            return self._decode(feats, shapes, run)

    def _encode(self, pyramid, shapes, run):
        """The input projections and the encoder layers: [B, I, D]."""
        B = pyramid[0].shape[0]
        feats = []
        for lvl, f in enumerate(pyramid):
            x = self.input_proj[lvl](f)
            x = x.reshape(B, -1, self.emb_dim) + self.level_embedding[lvl].to(
                x.dtype)
            feats.append(x)
        feats = torch.cat(feats, dim=1)  # [B, I, D]

        enc_refs = device_constant(
            self._constants, ("encoder_reference_points", shapes),
            lambda device: make_encoder_reference_points(shapes, device),
            feats)
        for layer in self.encoder_layers:
            feats = run(layer, feats, shapes, enc_refs)
        return feats

    def _decode(self, feats, shapes, run):
        """The proposals (two-stage), the decoder layers and the heads."""
        B = feats.shape[0]
        queries = self.query_embedding[None].expand(B, -1, -1)
        if self.compute_dtype is not None:
            queries = queries.to(self.compute_dtype)

        enc_out = None
        if self.two_stage:
            # every encoder pixel emits a proposal; the top num_queries seed
            # the decoder's reference boxes and positional content
            anchors = device_constant(
                self._constants, ("proposal_anchors", shapes),
                lambda device: make_proposal_anchors(shapes, device=device),
                feats)[None]
            enc_obj = self.enc_objectness(feats)[..., 0]
            enc_delta = self.enc_box_head(feats)
            enc_boxes = torch.sigmoid(_inv_sigmoid(anchors) + enc_delta)
            top_idx = torch.topk(enc_obj, self.num_queries, dim=1).indices
            refs = torch.gather(
                enc_boxes, 1, top_idx[..., None].expand(-1, -1, 4)
            )  # [B, Nq, 4]
            enc_out = {
                "logits": enc_obj[..., None],
                "boxes": enc_boxes,
                "anchors": anchors[0],
            }
            refs = refs.detach()
            queries = queries + self.proposal_pos_proj(refs)
        else:
            refs = torch.sigmoid(self.reference_box_logits)[None].expand(
                B, -1, -1)

        aux = []
        for i, layer in enumerate(self.decoder_layers):
            queries = run(layer, queries, feats, shapes, refs)
            if i < len(self.box_refine):
                # refs are detached between layers, as in the paper
                refined = torch.sigmoid(
                    _inv_sigmoid(refs) + self.box_refine[i](queries))
                aux.append({"logits": self.aux_class[i](queries),
                            "boxes": refined})
                refs = refined.detach()

        logits = self.class_head(queries)
        boxes = torch.sigmoid(_inv_sigmoid(refs) + self.box_head(queries))
        out = {"logits": logits, "boxes": boxes}
        if self.with_box_refinement:
            out["aux"] = aux
        if enc_out is not None:
            out["enc"] = enc_out
        return out


def _sampling_grid(num_heads: int, num_levels: int,
                   num_points: int) -> torch.Tensor:
    """Deformable DETR's initial sampling offsets, [H, L, P, 2] in pixels:
    head h looks along the angle 2*pi*h/H, point p at distance p + 1."""
    thetas = torch.arange(num_heads, dtype=torch.float64) * (
        2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    steps = torch.arange(1, num_points + 1, dtype=torch.float64)
    grid = grid[:, None, None, :] * steps[None, None, :, None]
    return grid.expand(num_heads, num_levels, num_points, 2).float()


@torch.no_grad()
def init_parameters(module: nn.Module,
                    generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter of ``module`` from ``generator`` (a CPU
    generator) the way Deformable DETR initialises an untrained model
    (arXiv:2010.04159; its reference code's ``_reset_parameters``):

    * Linear weights Xavier-uniform, biases zero; LayerNorm ones and zeros;
    * each MSDA query projection: zero weights, so that the sampling
      offsets start on a fixed per-head grid (the bias) and the attention
      weights start uniform;
    * box-refinement heads zero (refinement starts as the identity) and the
      class heads' bias at the focal-loss prior -log(99);
    * level and query embeddings normal(0.02), reference-box logits
      normal(0.5), as the JAX model draws them.

    With these weights the sampling positions do not depend on the
    features, so a full-width model is well conditioned: on an H100, a
    relative perturbation of 1e-7 in its input pyramid moved the logits by
    4e-6; with all-random projections the same perturbation moved them by
    3e-3, which would hide any kernel error under the model's own noise.
    Returns ``module``."""

    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, nn.Linear):
            uniform(m.weight, math.sqrt(6.0 / (m.in_features
                                               + m.out_features)))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if isinstance(m, MultiscaleDeformableAttention):
            proj = m.query_input_proj
            proj.weight.zero_()
            bias = proj.bias.view(m.num_heads, m.num_levels, m.num_points, 3)
            bias[..., :2] = _sampling_grid(m.num_heads, m.num_levels,
                                           m.num_points)
            bias[..., 2] = 0.0
        elif isinstance(m, DeformableDetr):
            normal(m.level_embedding, 0.02)
            normal(m.query_embedding, 0.02)
            if not m.two_stage:
                normal(m.reference_box_logits, 0.5)
            for head in m.box_refine:
                head.weight.zero_()
            prior = -math.log((1 - 0.01) / 0.01)
            for head in [m.class_head, *m.aux_class]:
                head.bias.fill_(prior)
    return module


def postprocess(outputs, top_k: int = 100, scoring: str = "softmax",
                image_sizes=None):
    """Decode detector outputs into ranked detections.

    DETR-style one-to-one decoding (no NMS): scores over all (query, class)
    pairs, global top-k, boxes gathered per selected query.  With
    ``image_sizes`` (``[B, 2]`` (height, width) per image), boxes are
    absolute ``(x0, y0, x1, y1)`` pixel coordinates; otherwise normalized
    ``(cx, cy, w, h)``.  ``image_sizes`` may be a host list, which is
    copied to the detections' device at each call (the host waits for that
    copy), or a tensor: one already on that device is used where it lies,
    with no copy from the host.  A serving function captured as a CUDA
    graph (``utils.graphs.graphed``) takes it as a device tensor, since a
    copy from the host cannot be captured.

    ``scoring``: ``"softmax"`` (default) takes a softmax over classes and
    drops the last class as background; ``"sigmoid"`` takes a per-class
    sigmoid over all classes (the focal-loss decode).

    Returns dict(scores=[B, K], labels=[B, K], boxes=[B, K, 4]), sorted by
    descending score.  Runs in the span ``postprocess``
    (``utils.profile.annotate``).
    """
    with annotate("postprocess"):
        return _decode(outputs, top_k, scoring, image_sizes)


def _decode(outputs, top_k, scoring, image_sizes):
    """``postprocess``'s body."""
    logits = outputs["logits"]
    boxes = outputs["boxes"]
    B, N, K = logits.shape
    if scoring == "softmax":
        probs = torch.softmax(logits, dim=-1)[..., :-1]  # drop background
        K = K - 1
        scores = probs.reshape(B, N * K)
    elif scoring == "sigmoid":
        scores = torch.sigmoid(logits).reshape(B, N * K)
    else:
        raise ValueError(
            f"scoring must be 'softmax' or 'sigmoid', got {scoring!r}"
        )
    top = min(int(top_k), N * K)
    sel_scores, flat_idx = torch.topk(scores, top, dim=-1, sorted=True)
    q_idx = torch.div(flat_idx, K, rounding_mode="floor")
    labels = flat_idx % K
    sel_boxes = torch.gather(boxes, 1, q_idx[..., None].expand(-1, -1, 4))
    if image_sizes is not None:
        sizes = torch.as_tensor(image_sizes).to(
            device=sel_boxes.device, dtype=sel_boxes.dtype)  # [B, 2] (h, w)
        scale = torch.stack(
            [sizes[:, 1], sizes[:, 0], sizes[:, 1], sizes[:, 0]], dim=-1
        )  # (w, h, w, h)
        sel_boxes = box_cxcywh_to_xyxy(sel_boxes) * scale[:, None, :]
    return {"scores": sel_scores, "labels": labels, "boxes": sel_boxes}
