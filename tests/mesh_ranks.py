"""Rank programs of ``tests/test_torch_sharding.py``.

Each runs in a process of its own, one rank of a gloo process group
(``msda_tpu_torch.dryrun.run_ranks``), and imports torch and the port only,
never JAX.  Inputs come from, and results go to, the test's directory
``d``; rank 0 writes the results.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from msda_tpu_torch.models import DeformableDetr
from msda_tpu_torch.parallel import (
    make_mesh, make_train_step, replicate_params,
    shard_map_multiscale_deformable_attention, shard_msda_args, shard_params,
    sharded_multiscale_deformable_attention)
from msda_tpu_torch.parallel.sharding import MSDA_SHARDINGS, axis, placements
from msda_tpu_torch.parallel.train import _tp_spec_for

MESH = {"dp": 2, "sp": 2, "tp": 2}


def op(rank, n, device, d):
    """The op under the (2, 2, 2) mesh, f32 and f64: the local blocks of
    ``shard_msda_args``, the output and the three gradients of
    ``sum(out * out_grad)`` through
    ``shard_map_multiscale_deformable_attention``, and the output of
    ``sharded_multiscale_deformable_attention`` on full tensors."""
    from torch.distributed.tensor import distribute_tensor

    mesh = make_mesh(MESH, device_type="cpu")
    data = np.load(os.path.join(d, "op_inputs.npz"))
    results, blocks = {}, {}
    for dtype in (torch.float32, torch.float64):
        img, pts, wts, og = (torch.from_numpy(data[k]).to(dtype)
                             for k in ("img", "pts", "wts", "og"))
        shapes = data["shapes"]
        img_d, shapes_d, pts_d, wts_d = shard_msda_args(mesh, img, shapes,
                                                        pts, wts)
        blocks = {k: list(t.to_local().shape) for k, t in
                  (("img", img_d), ("pts", pts_d), ("wts", wts_d))}
        for t in (img_d, pts_d, wts_d):
            t.requires_grad_(True)
        out = shard_map_multiscale_deformable_attention(
            mesh, img_d, shapes_d, pts_d, wts_d, "border", False,
            impl="reference")
        blocks["out"] = list(out.to_local().shape)
        og_d = distribute_tensor(og, mesh,
                                 placements(mesh, MSDA_SHARDINGS["out"]))
        (out * og_d).sum().full_tensor().backward()
        tag = str(dtype)[6:]
        results[f"out_{tag}"] = out.full_tensor().detach().numpy()
        for name, t in (("img", img_d), ("pts", pts_d), ("wts", wts_d)):
            results[f"{name}_grad_{tag}"] = t.grad.full_tensor().numpy()
        results[f"sharded_{tag}"] = sharded_multiscale_deformable_attention(
            mesh, img, shapes, pts, wts, "border", False,
            impl="reference").full_tensor().numpy()
    with open(os.path.join(d, f"blocks_{rank}.json"), "w") as f:
        json.dump(blocks, f)
    if rank == 0:
        np.savez(os.path.join(d, "op_results.npz"), **results)


def _whole(model, mesh, shapes):
    """Every parameter whole (``shapes``: the whole shapes by name): tp
    blocks gathered along their dimension."""
    tp, _, group = axis(mesh, "tp")
    out = {}
    for name, p in model.named_parameters():
        p = p.detach().contiguous()
        if tuple(p.shape) != tuple(shapes[name]):
            blocks = [torch.empty_like(p) for _ in range(tp)]
            dist.all_gather(blocks, p, group=group)
            p = torch.cat(blocks, _tp_spec_for(name, p))
        out[name] = p.numpy()
    return out


def train(rank, n, device, d):
    """One SGD step with the auction matcher under the (2, 2, 2) mesh from
    the JAX model's initial parameters, once with ``replicate_params`` and
    once with ``shard_params``: the loss, every updated parameter (whole),
    and which parameters ``shard_params`` cut, with their blocks' shapes."""
    with open(os.path.join(d, "train.json")) as f:
        cfg = json.load(f)
    state = torch.load(os.path.join(d, "params.pt"))
    data = np.load(os.path.join(d, "batch.npz"))
    mesh = make_mesh(MESH, device_type="cpu")
    dp, dc, _ = axis(mesh, "dp")
    per = len(data["mask"]) // dp

    def local(k):
        return torch.from_numpy(data[k][dc * per:(dc + 1) * per])

    pyramid = [local(f"level{i}") for i in range(len(cfg["shapes"]))]
    targets = {k: local(k) for k in ("labels", "boxes", "mask")}
    results, cut = {}, {}
    for place in (replicate_params, shard_params):
        model = DeformableDetr(**cfg["model"], mesh=mesh)
        model.load_state_dict(state)
        place(model, mesh)
        if place is shard_params:
            cut = {name: list(p.shape) for name, p in model.named_parameters()
                   if tuple(p.shape) != tuple(state[name].shape)}
        step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                      lr=cfg["lr"]),
                               cfg["shapes"], matcher="auction",
                               return_metrics=True, mesh=mesh)
        loss, metrics = step(pyramid, targets)
        tag = place.__name__
        results[f"{tag}/loss"] = np.float64(loss.item())
        results[f"{tag}/converged"] = np.bool_(
            bool(metrics["matcher_converged"]))
        whole = {k: v.shape for k, v in state.items()}
        for name, value in _whole(model, mesh, whole).items():
            results[f"{tag}/{name}"] = value
    if rank == 0:
        np.savez(os.path.join(d, "train_results.npz"), **results)
        with open(os.path.join(d, "cut.json"), "w") as f:
            json.dump(cut, f)
