"""Deformable-DETR detector built on the MSDA op (PyTorch).

The counterpart of ``msda_tpu/models/detr.py``: a deformable encoder over
the flattened feature pyramid, a decoder with learned queries, and detection
heads, the architecture of arXiv:2010.04159 §4 with both paper variants
(iterative box refinement and two-stage), and, beside the JAX package's
static-shape two-stage form, the two-stage form as published
(``two_stage="published"``) and DINO (arXiv:2203.03605, ``two_stage="dino"``:
``DeformableDetr``'s docstring).
``postprocess`` decodes the outputs into ranked detections.  Parameters
are made with PyTorch's default initialisation; :func:`init_parameters`
re-draws them from a ``torch.Generator``, and
``models.convert.state_dict_from_flax`` loads the JAX model's parameters.

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
from . import denoising
from .attention import Dense, MultiscaleDeformableAttention, device_constant

__all__ = [
    "make_encoder_reference_points",
    "make_proposal_anchors",
    "make_proposal_logits",
    "proposal_pos_embed",
    "box_pos_embed",
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
    return _on_device(_anchors(img_shapes, base_scale, 0.9), device)


def _anchors(img_shapes, base_scale: float, max_side: float) -> np.ndarray:
    """Every pyramid pixel's anchor box, cxcywh: its centre, and sides of
    ``base_scale * 2^level`` up to ``max_side``.  [I, 4], f64."""
    anchors = []
    for lvl, (h, w) in enumerate(level_shapes(img_shapes)):
        xs, ys = _pixel_centers(h, w)
        wh = np.full_like(xs, min(base_scale * (2 ** lvl), max_side))
        anchors.append(np.stack([xs, ys, wh, wh], axis=-1).reshape(-1, 4))
    return np.concatenate(anchors, axis=0)


def make_proposal_logits(img_shapes, device=None) -> torch.Tensor:
    """The published two-stage proposals' anchors in logit space: [I, 4].

    Each pyramid pixel anchors a box at its centre, of side ``0.05 *
    2^level`` (the official ``gen_encoder_output_proposals``), as
    ``log(p / (1 - p))``, and ``+inf`` in all four where any coordinate
    lies outside (0.01, 0.99): such a proposal's box is 1 whatever its
    head says, and its token enters the proposal heads as zeros.  f32.
    """
    anchors = _anchors(img_shapes, 0.05, np.inf)
    valid = ((anchors > 0.01) & (anchors < 0.99)).all(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        logits = np.log(anchors / (1.0 - anchors))
    return _on_device(np.where(valid, logits, np.inf), device)


def proposal_pos_embed(proposals: torch.Tensor, width: int) -> torch.Tensor:
    """The published two-stage decoder's positional embedding of its
    proposals (the official ``get_proposal_pos_embed``): ``proposals`` [...,
    4] in logit space, ``width`` a multiple of 8.  Each coordinate's
    sigmoid, times 2 pi, over ``10000^(2 floor(i / 2) / F)`` for i < F =
    ``width / 4``, the sine of the even i and the cosine of the odd i,
    interleaved: [..., width], f32.
    """
    return _sine_embed(proposals.float().sigmoid(), width)


def box_pos_embed(boxes: torch.Tensor, width: int) -> torch.Tensor:
    """DINO's positional embedding of its reference boxes (the official
    ``gen_sineembed_for_position``): ``boxes`` [..., 4] cxcywh in [0, 1],
    embedded as :func:`proposal_pos_embed` embeds a proposal's sigmoids but
    in DINO's (y, x, w, h) order: [..., width], f32."""
    boxes = boxes.float()
    # slices, not an index list: a list is a host tensor, which a CUDA
    # graph's capture cannot copy
    return _sine_embed(torch.cat([boxes[..., 1:2], boxes[..., :1],
                                  boxes[..., 2:]], -1), width)


def _sine_embed(pos: torch.Tensor, width: int) -> torch.Tensor:
    """Each coordinate of ``pos`` [..., 4] (in [0, 1]) times 2 pi, over
    ``10000^(2 floor(i / 2) / F)`` for i < F = ``width / 4``, the sine of
    the even i and the cosine of the odd i, interleaved: [..., width]."""
    feats = width // 4
    dim_t = torch.arange(feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                        / feats)
    pos = pos * (2 * math.pi)
    pos = pos[..., None] / dim_t  # [..., 4, F]
    pos = torch.stack((pos[..., 0::2].sin(), pos[..., 1::2].cos()), dim=-1)
    return pos.flatten(-3)


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


class _MLP(nn.Module):
    """``layers`` dense layers with a ReLU between two (DINO's ``MLP``): the
    widths ``n_in``, ``hidden`` ... ``hidden``, ``n_out``."""

    def __init__(self, n_in: int, hidden: int, n_out: int, layers: int,
                 compute_dtype=None, device=None):
        super().__init__()
        dims = [n_in] + [hidden] * (layers - 1) + [n_out]
        self.layers = nn.ModuleList(
            Dense(a, b, compute_dtype, device)
            for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == 0 else layer(torch.relu(x))
        return x


class MultiHeadSelfAttention(nn.Module):
    """Decoder query self-attention, as flax ``MultiHeadDotProductAttention``
    computes it: per-head query/key/value projections, scores scaled by
    ``1/sqrt(head_dim)``, a softmax over keys (in f32), no dropout, and an
    output projection.  Explicit matmuls, no fused attention kernel.
    With ``query_pos`` (the published two-stage form), queries and keys
    are projected from ``x + query_pos`` and values from ``x``.  ``mask``
    (``[N, N]`` bool, DINO's group mask) sets the scores where it is True
    to -inf; without it nothing is masked.
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

    def forward(self, x: torch.Tensor,
                query_pos: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        Dh = D // H

        def heads(t):  # [B, N, D] -> [B, H, N, Dh]
            return t.reshape(B, N, H, Dh).transpose(1, 2)

        qk = x if query_pos is None else x + query_pos
        q = heads(self.query(qk)) / math.sqrt(Dh)
        k = heads(self.key(qk))
        v = heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2))  # [B, H, N, N]
        if mask is not None:
            scores = scores.masked_fill(mask, float("-inf"))
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

    def forward(self, queries, feats, img_shapes, reference_points,
                query_pos=None, attn_mask=None):
        """queries [B, N, D]; feats [B, I, D]; reference_points [B, N, 2|4];
        query_pos None or [B, N, D] (the published two-stage form's and
        DINO's: added to the queries that attend, never to the residual);
        attn_mask None or the self-attention's [N, N] mask (DINO's)."""
        x = self.norm_0(queries, self.self_attn(queries, query_pos,
                                                attn_mask))
        y = self.msda(feats, img_shapes,
                      x if query_pos is None else x + query_pos,
                      reference_points)
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
      with ``enc`` outputs for proposal supervision: the JAX package's
      static-shape form;
    * *two-stage as published* (``two_stage="published"``; the official
      ``two_stage`` branch of ``DeformableTransformer.forward``, arXiv:
      2010.04159 §4.2 and App. A.4), in the span ``proposals`` inside
      ``decoder``: every encoder token, zeroed where its anchor
      (:func:`make_proposal_logits`) is invalid, is projected by
      ``enc_output`` (D to D) and ``enc_output_norm``; a class head
      (``enc_class_head``, K logits) and a box head (``enc_box_head``, 4
      deltas added to the anchor's logits) run over every token; the
      ``num_queries`` tokens of the highest logit 0 are chosen; their
      detached box logits, through :func:`proposal_pos_embed` (2D wide),
      ``pos_trans`` (2D to 2D) and ``pos_trans_norm``, are split into each
      decoder layer's ``query_pos`` (the first D) and the decoder's content
      queries (the second D), and their sigmoids are the first reference
      boxes.  There is no learned query embedding or reference box.  The
      ``enc`` outputs are ``{"logits": [B, I, K], "boxes": [B, I, 4],
      "top_idx": [B, num_queries]}``, the loss's
      (``parallel.detection_loss``) proposal term.  With box refinement
      the encoder's heads are a seventh class and box head beside the
      decoder's six; without it, heads of their own beside the decoder's
      one (the official shares the decoder's there);
    * *DINO* (``two_stage="dino"``; arXiv:2203.03605, the official
      ``DINO_5scale`` configuration with ``two_stage_type="standard"``,
      ``embed_init_tgt`` and the heads shared across the decoder layers):
      the published proposal stage but for its heads (``enc_class_head``,
      and ``enc_box_head`` a 3-layer MLP), in the span ``proposals``; the
      ``num_queries`` tokens of the highest class logit, any class, are
      chosen (*mixed query selection*): their detached boxes are the first
      reference boxes, the content queries a learned ``query_embedding``,
      and the heads at the chosen tokens, undetached, are the
      ``interm`` outputs.  Each decoder layer takes ``query_pos =
      ref_point_head(box_pos_embed(r))`` from its reference box r
      (``ref_point_head`` an MLP 2D to D to D); the layer's un-normed
      output o updates the box, ``sigmoid(box_head(o) + logit(r))``,
      detached for the next layer; the layer's prediction is
      ``class_head`` and ``box_head`` (one class head and one 3-layer box
      MLP shared by every layer) on ``decoder_norm(o)``, its box added to
      the logits of the layer before's updated box, undetached
      (*look forward twice*: layer i's loss trains layer i - 1).  Given
      ``targets`` and ``max_targets`` (a host int, the batch's largest
      count of real targets), the span ``dn_queries`` builds DINO's
      contrastive denoising queries (``models/denoising.py``: labels
      through ``label_enc``, noised boxes) and the group attention mask,
      and the DN queries run before the matching ones; their outputs come
      apart as ``dn`` (``{"logits", "boxes", "aux", "draws"}``) with
      ``dn_meta`` (host ints ``max_targets``, ``groups``, ``pad``), as
      the official ``dn_post_process`` splits them.  The outputs also hold
      ``proposals`` (``{"logits" [B, I, K], "top_idx" [B, num_queries]}``),
      which no loss reads.  ``aux`` holds the first layers' predictions
      whatever ``with_box_refinement`` says.

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
        two_stage: bool | str = False,
        remat: bool = False,
        compute_dtype: torch.dtype | None = None,
        impl: str = "auto",
        device=None,
        mesh=None,
    ):
        super().__init__()
        if two_stage not in (False, True, "published", "dino"):
            raise ValueError(f"two_stage must be False, True, 'published' "
                             f"or 'dino', got {two_stage!r}")
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
        if two_stage == "dino":
            self._init_dino(emb_dim, num_classes, num_queries, cd, device)
        elif two_stage == "published":
            self.enc_output = Dense(emb_dim, emb_dim, cd, device)
            self.enc_output_norm = LayerNorm(emb_dim, cd, device)
            self.enc_class_head = Dense(emb_dim, num_classes, device=device)
            self.enc_box_head = Dense(emb_dim, 4, device=device)
            self.pos_trans = Dense(2 * emb_dim, 2 * emb_dim, cd, device)
            self.pos_trans_norm = LayerNorm(2 * emb_dim, cd, device)
        else:
            self.query_embedding = nn.Parameter(
                torch.zeros(num_queries, emb_dim, device=device))
        if two_stage is True:
            self.enc_objectness = Dense(emb_dim, 1, device=device)
            self.enc_box_head = Dense(emb_dim, 4, device=device)
            self.proposal_pos_proj = Dense(4, emb_dim, cd, device)
        elif not two_stage:
            self.reference_box_logits = nn.Parameter(
                torch.zeros(num_queries, 4, device=device))
        self.decoder_layers = nn.ModuleList(
            DeformableDecoderLayer(**layer_args)
            for _ in range(num_decoder_layers))
        # the DINO form shares one class head and one box MLP across layers
        n_refine = (num_decoder_layers - 1
                    if with_box_refinement and two_stage != "dino" else 0)
        self.box_refine = nn.ModuleList(
            Dense(emb_dim, 4, device=device) for _ in range(n_refine))
        self.aux_class = nn.ModuleList(
            Dense(emb_dim, num_classes, device=device)
            for _ in range(n_refine))
        if two_stage == "dino":
            self.decoder_norm = LayerNorm(emb_dim, cd, device)
        self.class_head = Dense(emb_dim, num_classes, device=device)
        self.box_head = (_MLP(emb_dim, emb_dim, 4, 3, device=device)
                         if two_stage == "dino" else
                         Dense(emb_dim, 4, device=device))

    def _init_dino(self, D, num_classes, num_queries, cd, device):
        """The DINO form's own modules but the decoder's (the class
        docstring)."""
        self.enc_output = Dense(D, D, cd, device)
        self.enc_output_norm = LayerNorm(D, cd, device)
        self.enc_class_head = Dense(D, num_classes, device=device)
        self.enc_box_head = _MLP(D, D, 4, 3, device=device)
        self.query_embedding = nn.Parameter(
            torch.zeros(num_queries, D, device=device))
        self.ref_point_head = _MLP(2 * D, D, D, 2, cd, device)
        # a row a class and one more, as DINO's dn_labelbook_size + 1
        self.label_enc = nn.Embedding(num_classes + 1, D, device=device)

    def forward(self, pyramid: Sequence[torch.Tensor], img_shapes,
                targets: dict | None = None,
                max_targets: int | None = None):
        """pyramid: per-level features [B, h_l, w_l, C_l]; img_shapes [L, 2].

        Returns dict(logits=[B, N, num_classes], boxes=[B, N, 4] in
        normalized cxcywh), plus ``aux`` (box refinement) and ``enc``
        (two-stage).  ``targets`` (``detection_loss``'s) and ``max_targets``
        (a host int, the largest count of real targets of an image of the
        batch) build the DINO form's denoising queries; no other form takes
        them.
        """
        if max_targets is not None and self.two_stage != "dino":
            raise ValueError("targets and max_targets build the denoising "
                             "queries of DeformableDetr(two_stage='dino') "
                             "alone")
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
            if self.two_stage == "dino":
                with annotate("proposals"):
                    start = self._dino_proposals(feats, shapes)
                dn = None
                if targets is not None and max_targets:
                    with annotate("dn_queries"):
                        dn = self._dn_queries(targets, int(max_targets),
                                              feats)
                return self._decode_dino(feats, shapes, run, *start, dn)
            if self.two_stage == "published":
                with annotate("proposals"):
                    start = self._proposals(feats, shapes)
            else:
                start = self._queries(feats, shapes)
            return self._decode(feats, shapes, run, *start)

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

    def _queries(self, feats, shapes):
        """The decoder's first queries and reference boxes: learned, or
        from the proposals of the JAX package's two-stage form.  Returns
        ``(queries, query_pos None, refs, enc outputs or None)``."""
        B = feats.shape[0]
        queries = self.query_embedding[None].expand(B, -1, -1)
        if self.compute_dtype is not None:
            queries = queries.to(self.compute_dtype)
        if not self.two_stage:
            refs = torch.sigmoid(self.reference_box_logits)[None].expand(
                B, -1, -1)
            return queries, None, refs, None
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
        return queries, None, refs, enc_out

    def _proposal_heads(self, feats, shapes):
        """Every token's proposal, as the published two-stage form and DINO
        make them (the class docstring): ``(class logits [B, I, K], box
        logits [B, I, 4], +inf where the anchor is invalid)``."""
        logits = device_constant(
            self._constants, ("proposal_logits", shapes),
            lambda device: make_proposal_logits(shapes, device), feats)
        valid = device_constant(
            self._constants, ("proposal_valid", shapes),
            lambda device: logits.isfinite().all(-1, keepdim=True),
            feats)  # [I, 1]
        memory = self.enc_output_norm(self.enc_output(
            feats.masked_fill(~valid, 0.0)))
        return self.enc_class_head(memory), self.enc_box_head(memory) + logits

    def _proposals(self, feats, shapes):
        """The published two-stage form's proposal stage (the class
        docstring).  Returns ``(queries, query_pos, refs, enc outputs)``."""
        D = self.emb_dim
        enc_logits, enc_unact = self._proposal_heads(feats, shapes)
        top_idx = torch.topk(enc_logits[..., 0], self.num_queries,
                             dim=1).indices  # [B, Nq]
        top = torch.gather(enc_unact, 1, top_idx[..., None].expand(
            -1, -1, 4)).detach()
        pos = self.pos_trans_norm(self.pos_trans(proposal_pos_embed(
            top, 2 * D)))
        query_pos, queries = pos[..., :D], pos[..., D:]
        enc_out = {"logits": enc_logits, "boxes": torch.sigmoid(enc_unact),
                   "top_idx": top_idx}
        return queries, query_pos, torch.sigmoid(top), enc_out

    def _dino_proposals(self, feats, shapes):
        """The DINO form's proposal stage and mixed query selection (the
        class docstring).  Returns ``(queries, box logits [B, Nq, 4]
        detached, interm outputs, proposals)``."""
        B = feats.shape[0]
        enc_logits, enc_unact = self._proposal_heads(feats, shapes)
        top_idx = torch.topk(enc_logits.max(-1).values, self.num_queries,
                             dim=1).indices  # [B, Nq]
        K = enc_logits.shape[-1]
        top = torch.gather(enc_unact, 1, top_idx[..., None].expand(-1, -1, 4))
        interm = {"logits": torch.gather(
                      enc_logits, 1, top_idx[..., None].expand(-1, -1, K)),
                  "boxes": torch.sigmoid(top)}
        queries = self.query_embedding[None].expand(B, -1, -1)
        if self.compute_dtype is not None:
            queries = queries.to(self.compute_dtype)
        return (queries, top.detach(), interm,
                {"logits": enc_logits, "top_idx": top_idx})

    def _dn_queries(self, targets, m, feats):
        """The DN queries, their box logits and draws, and the group mask
        for a batch whose largest count of real targets is ``m``
        (``models/denoising.py``), or None where that makes none."""
        groups, pad = denoising.cdn_shape(m)
        if not pad:
            return None
        draws = denoising.draw(feats.shape[0], groups, m, self.num_classes,
                               feats.device)
        queries, unact = denoising.build(self.label_enc.weight, targets, m,
                                         groups, draws)
        if self.compute_dtype is not None:
            queries = queries.to(self.compute_dtype)
        mask = device_constant(
            self._constants, ("dn_mask", m, groups, self.num_queries),
            lambda device: denoising.attention_mask(m, groups,
                                                    self.num_queries, device),
            feats)
        return {"queries": queries, "unact": unact, "mask": mask,
                "draws": draws,
                "meta": {"max_targets": m, "groups": groups, "pad": pad}}

    def _decode_dino(self, feats, shapes, run, queries, unact, interm,
                     proposals, dn):
        """The DINO form's decoder and shared heads (the class docstring),
        over the DN queries (``dn``, or None) and the matching queries."""
        pad, mask = 0, None
        if dn is not None:
            pad, mask = dn["meta"]["pad"], dn["mask"]
            queries = torch.cat([dn["queries"], queries], 1)
            unact = torch.cat([dn["unact"], unact], 1)
        refs = torch.sigmoid(unact)
        before = refs  # the box the next prediction is added to
        preds = []
        n = len(self.decoder_layers)
        for i, layer in enumerate(self.decoder_layers):
            query_pos = self.ref_point_head(box_pos_embed(
                refs, 2 * self.emb_dim))
            queries = run(layer, queries, feats, shapes, refs, query_pos,
                          mask)
            hs = self.decoder_norm(queries)
            preds.append((self.class_head(hs), torch.sigmoid(
                self.box_head(hs) + _inv_sigmoid(before))))
            if i + 1 < n:
                before = torch.sigmoid(self.box_head(queries)
                                       + _inv_sigmoid(refs))
                refs = before.detach()

        def heads(part):
            return [{"logits": c[:, part], "boxes": b[:, part]}
                    for c, b in preds]

        matching = heads(slice(pad, None))
        out = dict(matching[-1], aux=matching[:-1], interm=interm,
                   proposals=proposals)
        if dn is not None:
            dn_heads = heads(slice(0, pad))
            out["dn"] = dict(dn_heads[-1], aux=dn_heads[:-1],
                             draws=dn["draws"])
            out["dn_meta"] = dn["meta"]
        return out

    def _decode(self, feats, shapes, run, queries, query_pos, refs, enc_out):
        """The decoder layers, the box refinement and the heads."""
        extra = () if query_pos is None else (query_pos,)
        aux = []
        for i, layer in enumerate(self.decoder_layers):
            queries = run(layer, queries, feats, shapes, refs, *extra)
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
      normal(0.5), as the JAX model draws them;
    * in the published two-stage form, the encoder's box head zero and its
      class head's bias at the prior, as the decoder's;
    * in the DINO form, the last layer of each box MLP zero, both class
      heads' biases at the prior and the label table normal(1), as the
      official DINO initialises them.

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
            published = m.two_stage == "published"
            dino = m.two_stage == "dino"
            if not published:
                normal(m.query_embedding, 0.02)
            if not m.two_stage:
                normal(m.reference_box_logits, 0.5)
            enc = [m.enc_box_head] if published else []
            if dino:
                enc = [m.enc_box_head.layers[-1], m.box_head.layers[-1]]
                normal(m.label_enc.weight, 1.0)
            for head in [*m.box_refine, *enc]:
                head.weight.zero_()
            enc = [m.enc_class_head] if published or dino else []
            prior = -math.log((1 - 0.01) / 0.01)
            for head in [m.class_head, *m.aux_class, *enc]:
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
