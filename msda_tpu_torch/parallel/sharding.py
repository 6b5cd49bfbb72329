"""Multi-device MSDA: the device mesh and the op's placements on it (the
PyTorch counterpart of ``msda_tpu/parallel/sharding.py``).

MSDA is embarrassingly parallel over (batch, queries, heads): no query
interacts with another, no head with another.  So over a mesh with the
axes ``("dp", "sp", "tp")`` the canonical placements are

    dp (data):     batch: img, points, weights and out on dim 0
    sp (sequence): queries: points, weights and out on dim 1, the pyramid
                   replicated (it is small next to the queries' work)
    tp (tensor):   heads: img, points, weights and out on dim 2

and with them the op needs no collective: each rank runs it (K1 and K2 on
the card) on its local block.  Communication appears only around it: the
attention module's row-parallel output projection is summed over tp and
its output gathered over sp (``models/attention.py``), and the train step
sums the gradients (``parallel/train.py``).  The collectives here carry
their own backward: each is the adjoint of the forward for an objective
that is the sum of every rank's loss.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of an
initialised process group, one process a device (gloo on the CPU, NCCL on
cards).  An axis that a mesh lacks counts as an axis of size 1.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.distributed as dist

from ..ops import level_shapes, multiscale_deformable_attention

# torch.distributed.tensor (DTensor, local_map) is imported where it is
# used: it takes about a second to import, which every process that
# imports the models would otherwise pay

__all__ = [
    "make_mesh",
    "MSDA_SHARDINGS",
    "placements",
    "shard_msda_args",
    "sharded_multiscale_deformable_attention",
    "shard_map_multiscale_deformable_attention",
    "axis",
    "sum_over",
    "gather_over",
]


def make_mesh(axes: Mapping[str, int], device_type: str = "cuda"):
    """Build a ``DeviceMesh`` from named axis sizes, e.g.
    ``{"dp": 2, "tp": 4}``, over the ranks of the default process group
    (``init_device_mesh`` initialises one from the environment, as
    ``torchrun`` sets it, when there is none)."""
    from torch.distributed.device_mesh import init_device_mesh

    sizes = tuple(int(s) for s in axes.values())
    n = math.prod(sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"mesh needs {n} devices but only {world} available")
    return init_device_mesh(device_type, sizes, mesh_dim_names=tuple(axes))


# The mesh axis of each dimension of the op's operands and output (None:
# not split), JAX's PartitionSpecs:
#   img:   [B, I, H, C]           -> (dp, None, tp, None)
#   pts:   [B, N, H, L, P, 2]     -> (dp, sp, tp, ...)
#   wts:   [B, N, H, L, P]        -> (dp, sp, tp, ...)
#   out:   [B, N, H, C]           -> (dp, sp, tp, None)
MSDA_SHARDINGS = {
    "img": ("dp", None, "tp", None),
    "img_shapes": (None, None),
    "sampling_points": ("dp", "sp", "tp", None, None, None),
    "attention_weights": ("dp", "sp", "tp", None, None),
    "out": ("dp", "sp", "tp", None),
}


def placements(mesh, spec, partial=()) -> tuple:
    """The DTensor placements, one per mesh axis, of a tensor laid out by
    ``spec`` (an entry of ``MSDA_SHARDINGS``): ``Shard(dim)`` along an
    axis that ``spec`` names, ``Partial()`` along the axes of ``partial``
    (a gradient summed over them), ``Replicate()`` along the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        if name in spec:
            out.append(Shard(spec.index(name)))
        elif name in partial:
            out.append(Partial())
        else:
            out.append(Replicate())
    return tuple(out)


def shard_msda_args(mesh, img, img_shapes, sampling_points,
                    attention_weights):
    """Place the op's operands, full tensors equal on every rank, onto the
    mesh with the canonical placements.  Returns ``(img, img_shapes,
    sampling_points, attention_weights)``: three DTensors (each rank holds
    its block) and the level shapes, a host value that every rank holds
    whole."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, name):
        return distribute_tensor(x, mesh, placements(mesh,
                                                     MSDA_SHARDINGS[name]))

    return (put(img, "img"), level_shapes(img_shapes),
            put(sampling_points, "sampling_points"),
            put(attention_weights, "attention_weights"))


def shard_map_multiscale_deformable_attention(
    mesh,
    img,
    img_shapes,
    sampling_points,
    attention_weights,
    padding_mode: str = "border",
    align_corners: bool = False,
    *,
    impl: str = "auto",
):
    """MSDA on the mesh, each rank on its local (batch, query, head) block:
    the counterpart of ``jax.shard_map``, through ``local_map``.

    ``img``, ``sampling_points`` and ``attention_weights`` are DTensors in
    the canonical placements (``shard_msda_args``), and the result is one
    too; or each rank's local blocks as plain tensors, and then so is the
    result (the attention module calls it so).  Either way the op, and so
    the custom operators and their kernels, see plain local tensors only.
    There is no collective: the op has no cross-(batch, query, head)
    interaction.  ``img``'s gradient is partial over sp (each rank's
    queries reach the whole pyramid).  ``img_shapes`` is a host value."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    shapes = level_shapes(img_shapes)

    def local_op(img_l, pts_l, wts_l):
        return multiscale_deformable_attention(
            img_l, shapes, pts_l, wts_l, padding_mode, align_corners,
            impl=impl)

    operands = (img, sampling_points, attention_weights)
    if not any(isinstance(t, DTensor) for t in operands):
        # local blocks: local_map would call local_op as it is; skip its
        # placements, which cost host time on every call of the model
        return local_op(*operands)

    specs = tuple(placements(mesh, MSDA_SHARDINGS[name]) for name in
                  ("img", "sampling_points", "attention_weights"))
    grad_specs = (placements(mesh, MSDA_SHARDINGS["img"], partial=("sp",)),
                  *specs[1:])
    return local_map(
        local_op,
        # a list: local_map reads a tuple as one placement list an output
        out_placements=list(placements(mesh, MSDA_SHARDINGS["out"])),
        in_placements=specs,
        in_grad_placements=grad_specs,
        device_mesh=mesh,
    )(*operands)


def sharded_multiscale_deformable_attention(
    mesh,
    img,
    img_shapes,
    sampling_points,
    attention_weights,
    padding_mode: str = "border",
    align_corners: bool = False,
    *,
    impl: str = "auto",
):
    """MSDA on the mesh from operands in any placement: DTensors, or full
    tensors equal on every rank.  Each is redistributed to the canonical
    placements (the counterpart of JAX's sharding constraints; from a full
    tensor that is a local slice, with its gradient) and the op runs as
    :func:`shard_map_multiscale_deformable_attention` runs it.  Returns a
    DTensor in ``MSDA_SHARDINGS["out"]``."""
    from torch.distributed.tensor import DTensor, Replicate

    def canonical(x, name):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, placements(mesh, MSDA_SHARDINGS[name]))

    return shard_map_multiscale_deformable_attention(
        mesh, canonical(img, "img"), img_shapes,
        canonical(sampling_points, "sampling_points"),
        canonical(attention_weights, "attention_weights"),
        padding_mode, align_corners, impl=impl)


def axis(mesh, name: str):
    """``(size, coordinate, group)`` of this rank on the mesh axis
    ``name``; ``(1, 0, None)`` when the mesh lacks it."""
    if name not in mesh.mesh_dim_names:
        return 1, 0, None
    return (mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name), mesh.get_group(name))


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a group; the backward sums the gradients over
    it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherOver(torch.autograd.Function):
    """All-gather over a group, concatenated along ``dim``; the backward
    sums the gradients over the group and keeps this rank's block (a
    reduce-scatter, written with an all-reduce, which gloo has)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        blocks = [torch.empty_like(x)
                  for _ in range(dist.get_world_size(group))]
        dist.all_gather(blocks, x, group=group)
        return torch.cat(blocks, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        block = grad.chunk(n, ctx.dim)[dist.get_rank(ctx.group)]
        return block.contiguous(), None, None


def sum_over(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """``x`` summed over the mesh axis ``name``, differentiably; ``x``
    itself where the axis has one rank."""
    size, _, group = axis(mesh, name)
    return x if size == 1 else _SumOver.apply(x, group)


def gather_over(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` of the ranks along the mesh axis ``name``,
    concatenated along ``dim`` in their order, differentiably; ``x`` itself
    where the axis has one rank."""
    size, _, group = axis(mesh, name)
    return x if size == 1 else _GatherOver.apply(x, group, dim)
