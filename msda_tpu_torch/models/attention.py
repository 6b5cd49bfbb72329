"""MultiscaleDeformableAttention module (PyTorch).

The counterpart of ``msda_tpu/models/attention.py``: three projections
(img input, query input producing per-point offsets and weight logits, query
output), a softmax over the flattened (levels x points) axis, and 2- or
4-coordinate reference points.  The projections are ``nn.Linear``s whose
``state_dict`` keys (``img_input_proj`` / ``query_input_proj`` /
``query_output_proj``) are msda-triton's.

Known reference quirk, kept deliberately: for 2-coordinate reference points
msda-triton divides the (x, y) offsets by ``img_shapes``, which is in
**(height, width)** order, so x-offsets are normalized by the height and
y-offsets by the width.  ``offset_normalizer="reference"`` (default) keeps
that; ``offset_normalizer="detr"`` uses the original paper's (w, h) order.

Where autograd records nothing and the op would run K1 (CUDA tensors in
bf16, f16 or f32, ``resolved_impl`` "cuda", ``stream.FORCE`` not set,
no mesh) on shapes its prologue variant takes (``cuda_fwd_queries.takes``:
3 to 32 points a head, the model's 16 among them), the query projection's
output goes straight to the operator
``torch.ops.msda_tpu_torch.msda_fwd_queries`` (``ops/library.py``): K1's
prologue variant computes the softmax and the sampling locations in the
kernel, in the chain's f32 operations, where the chain
(``ops.cuda_fwd_queries.sampling_plain``) writes f32 points and weights to
device memory for K1 to read back.  Every other call (the CPU, f64,
training, the mesh, ``impl="reference"``, forced streaming) runs the
chain and the op.  The variant's launch counter, ``msda_fwd_queries``
(``ops/launches.py``), counts the calls that took the route.

With a device ``mesh`` (``parallel.sharding``), the module runs its share:
the rank's block of queries (sp) and of heads (tp).  The two input
projections are column-parallel (a contiguous block of their output
features is a block of whole heads: the layouts are head-major), the op
runs on the local block (``shard_map_multiscale_deformable_attention``),
and the output projection is row-parallel: its partial sums are summed
over tp, its bias added once after that, and the queries gathered over
sp.  A projection cut by ``parallel.shard_params`` holds its block; an
uncut one is sliced here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (cuda_fwd, cuda_fwd_queries, level_shapes, library,
                   multiscale_deformable_attention, resolved_impl, stream)
from ..parallel.sharding import (axis, gather_over,
                                 shard_map_multiscale_deformable_attention,
                                 sum_over)

__all__ = ["Dense", "MultiscaleDeformableAttention"]

def device_constant(cache: dict, key, make,
                    like: torch.Tensor) -> torch.Tensor:
    """``make(device)``, a tensor made from host data that depends on the
    hashable ``key`` only (the pyramid's shapes, a dtype), on ``like``'s
    device.

    It is made once per key and device and kept in ``cache`` (a module's
    own dict), as ``jax.jit`` keeps a program's constants: on a card, a
    copy from the host in every call makes the host wait for the card,
    and cannot be captured in a CUDA graph (``parallel.make_train_step``
    captures the train step).  The cache holds one entry per key, so it
    grows with the number of pyramid shapes the module sees.  While
    ``torch.export`` or ``torch.compile`` traces (``like`` is then not a
    plain tensor), it is made at each call, and a tensor made on the
    device there becomes one of the program's constants.
    """
    if type(like) is not torch.Tensor or torch.compiler.is_compiling():
        return make(like.device)
    slot = (key, like.device)
    if slot not in cache:
        with torch.inference_mode(False):  # usable by autograd later
            cache[slot] = make(like.device)
    return cache[slot]


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s dtype policy.

    With ``compute_dtype`` set, input, weight and bias are cast to it and the
    product is computed and returned in it (f32 master weights, half
    precision activations).  Without it, the input and the weight are
    promoted to their common dtype.
    """

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype | None = None, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def block(self, x: torch.Tensor, dim: int, rank: int, parts: int,
              bias: bool = True) -> torch.Tensor:
        """``x`` through block ``rank`` of ``parts`` of the layer: a block
        of its output features (``dim=0``, column-parallel) or of its input
        features (``dim=1``, row-parallel: a partial sum, with no bias
        unless ``bias``), in ``forward``'s dtype policy.  A weight that
        ``parallel.shard_params`` cut is the block already; a whole one is
        sliced here."""
        size = (self.out_features if dim == 0 else self.in_features) // parts

        def cut(t, d):
            return t if t.shape[d] == size else t.narrow(d, rank * size, size)

        weight = cut(self.weight, dim)
        dt = self.compute_dtype or torch.promote_types(x.dtype, weight.dtype)
        b = None
        if bias:
            b = (cut(self.bias, 0) if dim == 0 else self.bias).to(dt)
        return F.linear(x.to(dt), weight.to(dt), b)


class MultiscaleDeformableAttention(nn.Module):
    """Multiscale deformable attention with input/output projections.

    See Figure 2 of https://arxiv.org/pdf/2010.04159 for the op.

    Args:
        emb_dim: feature dimension of inputs/outputs.
        hidden_dim: projected feature dimension; must be divisible by
            ``num_heads``.
        num_levels: number of feature pyramid levels.
        num_heads: number of attention heads.
        num_points: sampling points per head per level.
        padding_mode: "border" or "zeros" out-of-bounds handling.
        align_corners: grid alignment (see grid_sample docs).
        offset_normalizer: "reference" (msda-triton's (h, w) order) or
            "detr" (the original paper's (w, h)).
        impl: forwarded to :func:`multiscale_deformable_attention`.
        compute_dtype: ``None`` or ``torch.bfloat16``: the projections and
            the projected pyramid run in it; the sampling-point and weight
            math stays in at least f32.
        device: where the parameters are made.
        mesh: ``None``, or a device mesh with axes among ("dp", "sp",
            "tp") (``parallel.make_mesh``): the module then takes this
            rank's dp block of the batch and runs its share of the queries
            (sp) and heads (tp), which must divide them.
    """

    def __init__(
        self,
        emb_dim: int,
        hidden_dim: int,
        num_levels: int,
        num_heads: int,
        num_points: int,
        padding_mode: str = "border",
        align_corners: bool = False,
        offset_normalizer: str = "reference",
        impl: str = "auto",
        compute_dtype: torch.dtype | None = None,
        device=None,
        mesh=None,
    ):
        super().__init__()
        if hidden_dim % num_heads != 0:
            raise ValueError(
                f"Hidden dimension (hidden_dim={hidden_dim}) should be "
                f"divisible by number of heads (num_heads={num_heads})."
            )
        if offset_normalizer not in ("reference", "detr"):
            raise ValueError(
                "offset_normalizer must be 'reference' or 'detr', got "
                f"{offset_normalizer!r}"
            )
        self.emb_dim = emb_dim
        self.hidden_dim = hidden_dim
        self.num_levels = num_levels
        self.num_heads = num_heads
        self.num_points = num_points
        self.padding_mode = padding_mode
        self.align_corners = align_corners
        self.offset_normalizer = offset_normalizer
        self.impl = impl
        self.mesh = mesh
        self._constants = {}  # the level sizes by shapes (device_constant)
        H, L, P = num_heads, num_levels, num_points
        self.img_input_proj = Dense(emb_dim, hidden_dim, compute_dtype, device)
        self.query_input_proj = Dense(emb_dim, H * L * P * 3, compute_dtype,
                                      device)
        self.query_output_proj = Dense(hidden_dim, emb_dim, compute_dtype,
                                       device)

    def forward(self, img, img_shapes, queries, reference_points):
        """Args:
            img: ``[B, I, emb_dim]`` flattened feature pyramid.
            img_shapes: ``[L, 2]`` integer (height, width) per level.
            queries: ``[B, N, emb_dim]`` latent queries.
            reference_points: ``[B, N, 2]`` normalized (x, y) positions or
                ``[B, N, 4]`` normalized (cx, cy, w, h) boxes.

        Returns:
            ``[B, N, emb_dim]``.
        """
        B, I, _ = img.shape  # noqa: E741
        H, L, P = self.num_heads, self.num_levels, self.num_points
        Dh = self.hidden_dim // H
        mesh = self.mesh
        if mesh is None:
            def project(layer, x):
                return layer(x)
        else:
            tp, t, _ = axis(mesh, "tp")
            sp, s, _ = axis(mesh, "sp")
            N = queries.shape[1]
            if H % tp or N % sp:
                raise ValueError(
                    f"a mesh with tp={tp} and sp={sp} needs the heads ({H}) "
                    f"divisible by tp and the queries ({N}) by sp")
            H, n = H // tp, N // sp
            queries = queries[:, s * n:(s + 1) * n]
            reference_points = reference_points[:, s * n:(s + 1) * n]

            def project(layer, x):  # column-parallel: this rank's heads
                return layer.block(x, 0, t, tp)
        N = queries.shape[1]

        q = project(self.query_input_proj, queries).reshape(B, N, H, L, P, 3)
        img_p = project(self.img_input_proj, img).reshape(B, I, H, Dh)
        shapes = level_shapes(img_shapes)
        if self._fused(img_p, q, reference_points, shapes):
            out = library.msda_fwd_queries(
                img_p, q, reference_points, library.flat_shapes(shapes),
                self.offset_normalizer, self.padding_mode,
                bool(self.align_corners))
            return self.query_output_proj(out.reshape(B, N, H * Dh))

        hw = None
        if reference_points.shape[-1] == 2:
            dt = torch.promote_types(q.dtype, torch.float32)
            hw = device_constant(  # (h, w) order
                self._constants, (shapes, dt),
                lambda device: torch.tensor(shapes, dtype=dt, device=device),
                q)
        sampling_points, attention_weights = cuda_fwd_queries.sampling_plain(
            q, reference_points, shapes, self.offset_normalizer, hw)

        if mesh is None:
            out = multiscale_deformable_attention(
                img_p, shapes, sampling_points, attention_weights,
                self.padding_mode, self.align_corners, impl=self.impl,
            )
            return self.query_output_proj(out.reshape(B, N, H * Dh))

        out = shard_map_multiscale_deformable_attention(
            mesh, img_p, shapes, sampling_points, attention_weights,
            self.padding_mode, self.align_corners, impl=self.impl,
        ).reshape(B, N, H * Dh)
        if tp == 1:
            y = self.query_output_proj(out)
        else:  # row-parallel: partial sums over tp, the bias added once
            y = sum_over(self.query_output_proj.block(out, 1, t, tp,
                                                      bias=False), mesh, "tp")
            y = y + self.query_output_proj.bias.to(y.dtype)
        return gather_over(y, mesh, "sp", 1)

    def _fused(self, img, q, reference_points, shapes) -> bool:
        """Whether the call takes ``msda_fwd_queries``: no mesh, CUDA
        tensors, ``img`` and ``q`` of one kernel dtype, 2- or 4-coordinate
        reference points of a kernel dtype, shapes the variant takes
        (``cuda_fwd_queries.takes``), the op resolving to "cuda" and not
        forced to stream (``stream.FORCE``), and autograd recording
        nothing."""
        return (self.mesh is None and q.is_cuda
                and q.dtype == img.dtype and q.dtype in cuda_fwd.DTYPE_CODES
                and reference_points.dtype in cuda_fwd.DTYPE_CODES
                and reference_points.shape[-1] in (2, 4)
                and img.device == q.device == reference_points.device
                and cuda_fwd_queries.takes(img, q)
                and resolved_impl(self.impl, shapes, img.dtype,
                                  img.device) == "cuda"
                and not stream.FORCE
                and not (torch.is_grad_enabled() and any(
                    t.requires_grad for t in (img, q, reference_points))))
