"""The published two-stage detector (``DeformableDetr(two_stage="published")``)
and the auction's large-N path that its proposal loss needs, against plain
versions written apart from the port.

On the CPU, at ``utils.DEFAULT_CFG``'s size (4 heads of 32 channels, 4
levels of a 16-base pyramid, 3 points, 80 queries over 340 tokens): the
port's forward, loss and every parameter's gradient against the
benchmark's plain reference (``perfbench/reference/detr_two_stage.py``,
``loss_two_stage.py``) on seeded weights, with box refinement and
without, and with the port's selection forced off the reference's at rank
80, where the reference decodes from the port's selection (the check of
the benchmark's two-stage cell does so); the sine embedding against its
formula written out; the one-stage decoder layer, which now takes an
optional ``query_pos``, against its equations as they were before it did,
bitwise; the large-N path's plain version against the whole auction and
against ``scipy.optimize.linear_sum_assignment``.

On the card (``cuda``; skips without one): the large-N path's kernels at
the proposal matching's shapes (N = 22,223 and 88,750, M = 50) against
the plain auction over the whole cost, index for index, eagerly and
replayed from a CUDA graph.  The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_two_stage_published.py

Tolerances: the forward 1e-5 of max(1, |ref|) and the loss 1e-5 relative
(f32 in both, the port's sums in other orders); gradients 1e-4 of each
parameter's largest reference gradient (f32 sums through 2 + 2 layers),
floored at the median parameter's, as the benchmark's ``grad_gap`` is (a
key's bias has no gradient but rounding, softmax being blind to it).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from msda_tpu_torch.models import DeformableDetr
from msda_tpu_torch.models import detr as detr_module
from msda_tpu_torch.parallel import (auction_assignment, cuda_auction_large,
                                     cuda_matcher, detection_loss)
from msda_tpu_torch.parallel.matcher import plain_auction
from perfbench import inputs, inputs_two_stage
from perfbench.drivers import train2s
from perfbench.reference import detr_two_stage as ref_detr
from perfbench.reference import loss_two_stage as ref_loss
from utils import DEFAULT_CFG, make_pyramid_shapes

ROOT = Path(__file__).resolve().parents[1]
EPS = 1e-3  # the matcher's bid increment


def _cfg(refine: bool) -> dict:
    """The benchmark's two-stage configuration at DEFAULT_CFG's size."""
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "ddetr-2stage-refine.json").read_text())
    H, C, L, P = (DEFAULT_CFG[k] for k in "HCLP")
    cfg.update(emb_dim=H * C, num_heads=H, head_dim=C, num_levels=L,
               num_points=P, num_encoder_layers=2, num_decoder_layers=2,
               ffn_dim=256, num_queries=DEFAULT_CFG["N"], num_classes=7,
               in_channels=[16, 24, 32, 32], with_box_refinement=refine)
    return cfg


def _model(cfg, weights):
    model = DeformableDetr(
        num_classes=cfg["num_classes"], in_channels=tuple(cfg["in_channels"]),
        emb_dim=cfg["emb_dim"], num_heads=cfg["num_heads"],
        num_points=cfg["num_points"], num_queries=cfg["num_queries"],
        num_encoder_layers=cfg["num_encoder_layers"],
        num_decoder_layers=cfg["num_decoder_layers"], ffn_dim=cfg["ffn_dim"],
        with_box_refinement=cfg["with_box_refinement"],
        two_stage="published")
    model.load_state_dict(weights, strict=True)
    return model


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B = DEFAULT_CFG["B"]
    shapes = [tuple(map(int, s)) for s in make_pyramid_shapes(
        cfg["num_levels"])]
    pyramid = [torch.from_numpy(rng.standard_normal((B, h, w, c),
                                                    dtype=np.float32))
               for (h, w), c in zip(shapes, cfg["in_channels"])]
    targets = inputs.targets(cfg, {"batch": B, "target_slots": 8,
                                   "real_targets": [3, 6],
                                   "box_wh": [0.05, 0.5]},
                             torch.Generator().manual_seed(seed), "cpu")
    return pyramid, tuple(shapes), targets


def _program_loss(out, targets, cfg):
    lc = cfg["loss"]
    return detection_loss(out, targets, matcher=lc["matcher"],
                          class_loss=lc["class_loss"],
                          aux_weight=lc["aux_weight"],
                          enc_weight=lc["enc_weight"],
                          l1_weight=lc["l1_weight"],
                          giou_weight=lc["giou_weight"],
                          matcher_rounds=lc["matcher_rounds"])


def _close(got, want, tol=1e-5):
    got, want = got.detach(), want.detach()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


def _swap_last(monkeypatch, queries, tokens):
    """Make the port's top-k of ``queries`` of the ``tokens`` proposals take
    the (k+1)-th in place of the k-th: its selection then differs from the
    reference's by one near-tie at rank k."""
    real = torch.topk

    def topk(x, k, *args, **kwargs):
        if x.ndim == 2 and k == queries and x.shape[1] == tokens:
            top = real(x, k + 1, *args, **kwargs)
            keep = torch.cat([top.indices[:, :k - 1], top.indices[:, k:]], 1)
            return torch.return_types.topk((x.gather(1, keep), keep))
        return real(x, k, *args, **kwargs)

    monkeypatch.setattr(detr_module.torch, "topk", topk)


@pytest.mark.parametrize("refine,near_tie", [(True, False), (False, False),
                                             (True, True)],
                         ids=["refine", "no_refine", "refine_near_tie"])
def test_published_form_against_the_plain_reference(monkeypatch, refine,
                                                    near_tie):
    torch.set_num_threads(1)
    cfg = _cfg(refine)
    weights = inputs_two_stage.detector_weights(cfg, 11, "cpu")
    model = _model(cfg, weights)
    pyramid, shapes, targets = _batch(cfg, 3)
    tokens = sum(h * w for h, w in shapes)
    assert tokens == 340
    if near_tie:
        _swap_last(monkeypatch, cfg["num_queries"], tokens)
    out = model(pyramid, shapes)
    loss = _program_loss(out, targets, cfg)
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    monkeypatch.undo()

    own = ref_detr.forward(weights, cfg, pyramid)["enc"]["top_idx"]
    params = {n: t.clone().requires_grad_() for n, t in weights.items()}
    ref = ref_detr.forward(params, cfg, pyramid,
                           top_idx=out["enc"]["top_idx"])
    ref_l = ref_loss.detection_loss(ref, targets, cfg["loss"])
    ref_grads = dict(zip(params, torch.autograd.grad(
        ref_l, list(params.values()))))

    for key in ("logits", "boxes"):
        _close(out["enc"][key], ref["enc"][key])
        _close(out[key], ref[key])
    for a, b in zip(out.get("aux", []), ref.get("aux", [])):
        _close(a["logits"], b["logits"])
        _close(a["boxes"], b["boxes"])
    assert len(out.get("aux", [])) == (1 if refine else 0)
    same = [set(a.tolist()) == set(b.tolist())
            for a, b in zip(out["enc"]["top_idx"], own)]
    gap = train2s.selection_gap({"top_idx": [out["enc"]["top_idx"]]},
                                {"logit0": [ref["enc"]["logits"][..., 0]
                                            .detach()]})
    if near_tie:
        assert not any(same)
        # the reference's k-th logit less its (k+1)-th: a near-tie
        kth = ref["enc"]["logits"][..., 0].detach().topk(
            cfg["num_queries"] + 1, dim=1).values
        assert gap == pytest.approx(float((kth[:, -2] - kth[:, -1]).max()),
                                    abs=1e-6)
        assert 0 < gap < 0.5
    else:
        assert all(same) and gap == 0.0
    assert float(loss.detach()) == pytest.approx(float(ref_l.detach()),
                                               rel=1e-5)
    assert set(grads) == set(ref_grads) == set(weights)
    for name in ("enc_output.weight", "enc_class_head.weight",
                 "enc_box_head.weight", "pos_trans.weight",
                 "pos_trans_norm.weight"):
        assert ref_grads[name].abs().max() > 0, name
    floor = float(np.median([float(g.abs().max())
                             for g in ref_grads.values()]))
    for name, g in ref_grads.items():
        assert float((grads[name] - g).abs().max()) <= 1e-4 * max(
            float(g.abs().max()), floor), name


def test_sine_embedding_against_its_formula():
    g = torch.Generator().manual_seed(2)
    boxes = torch.randn((2, 5, 4), generator=g) * 3
    boxes[0, 0, 2] = math.inf  # an invalid anchor's proposal
    got = detr_module.proposal_pos_embed(boxes, 64)
    assert got.shape == (2, 5, 64)
    F = 16
    want = torch.empty((2, 5, 64), dtype=torch.float64)
    for b, q, c, i in np.ndindex(2, 5, 4, F):
        p = 1.0 / (1.0 + math.exp(-float(boxes[b, q, c])))
        a = p * 2 * math.pi / 10000 ** (2 * (i // 2) / F)
        want[b, q, c * F + i] = math.sin(a) if i % 2 == 0 else math.cos(a)
    assert torch.allclose(got.double(), want, atol=2e-6)
    assert torch.allclose(ref_detr.pos_embed(boxes, 64).double(), want,
                          atol=2e-6)


def test_proposal_logits_mask_the_border_anchors():
    shapes = ((16, 16), (8, 8), (4, 4), (2, 2))
    got = detr_module.make_proposal_logits(shapes)
    want = ref_detr.anchor_logits(shapes, "cpu")
    assert torch.allclose(got, want, rtol=1e-6, atol=0.0)
    invalid = ~got.isfinite().all(-1)
    # the 16 x 16 level's centres 1/32 and 31/32 lie inside (0.01, 0.99);
    # the 2 x 2 level's side 0.4 too: every anchor is valid here
    assert not invalid.any()
    big = detr_module.make_proposal_logits(((100, 167),))
    centres = torch.sigmoid(big[..., :2].clamp(max=50))
    assert (~big.isfinite().all(-1)).sum() == 4 * 100 + 2 * 167 - 8
    assert ((centres < 0.99) & (centres > 0.01)).all(-1)[
        big.isfinite().all(-1)].all()


def _old_self_attention(attn, x):
    """``MultiHeadSelfAttention.forward`` as it was before ``query_pos``."""
    B, N, D = x.shape
    H = attn.num_heads
    Dh = D // H

    def heads(t):
        return t.reshape(B, N, H, Dh).transpose(1, 2)

    q = heads(attn.query(x)) / math.sqrt(Dh)
    k = heads(attn.key(x))
    v = heads(attn.value(x))
    scores = torch.matmul(q, k.transpose(-1, -2))
    weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    y = torch.matmul(weights, v).transpose(1, 2).reshape(B, N, D)
    return attn.out(y)


def _old_decoder_layer(layer, queries, feats, img_shapes, reference_points):
    """``DeformableDecoderLayer.forward`` as it was before ``query_pos``."""
    x = layer.norm_0(queries, _old_self_attention(layer.self_attn, queries))
    y = layer.msda(feats, img_shapes, x, reference_points)
    x = layer.norm_1(x, y)
    return layer.ffn(x)


def test_one_stage_decoder_is_bitwise_what_it_was(monkeypatch):
    """``ddetr-refine``'s path (no ``query_pos``) gives bitwise the
    outputs of the decoder's equations before ``query_pos`` was added."""
    torch.set_num_threads(1)
    cfg = _cfg(True)
    weights = inputs.detector_weights(cfg, 5, "cpu")
    model = DeformableDetr(
        num_classes=cfg["num_classes"], in_channels=tuple(cfg["in_channels"]),
        emb_dim=cfg["emb_dim"], num_heads=cfg["num_heads"],
        num_points=cfg["num_points"], num_queries=cfg["num_queries"],
        num_encoder_layers=2, num_decoder_layers=2, ffn_dim=cfg["ffn_dim"],
        with_box_refinement=True)
    model.load_state_dict(weights, strict=True)
    pyramid, shapes, _ = _batch(cfg, 4)
    with torch.no_grad():
        got = model(pyramid, shapes)
        monkeypatch.setattr(detr_module.DeformableDecoderLayer, "forward",
                            _old_decoder_layer)
        want = model(pyramid, shapes)
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["boxes"], want["boxes"])
    for a, b in zip(got["aux"], want["aux"]):
        assert torch.equal(a["logits"], b["logits"])
        assert torch.equal(a["boxes"], b["boxes"])


def _costs(kind, B, N, M, seed):
    """Seeded ``(cost [B, N, M] f32, active [B, M] bool or None)``."""
    rng = np.random.default_rng(seed)
    cost = rng.random((B, N, M), dtype=np.float32)
    active = None
    if kind == "ties":
        cost = np.floor(cost * 4).astype(np.float32)
    elif kind in ("masked", "empty_image"):
        # the proposal matching's: a few real targets, or none in image 0
        active = np.zeros((B, M), bool)
        for b in range(B):
            active[b, :rng.integers(5, 10)] = True
        if kind == "empty_image":
            active[0] = False
        cost = np.where(active[:, None, :], cost, 0).astype(np.float32)
        active = torch.from_numpy(active)
    return torch.from_numpy(cost), active


@pytest.mark.parametrize("kind,B,N,M", [
    ("uniform", 2, 12_300, 12),
    ("uniform", 2, 22_223, 50),
    ("masked", 2, 22_223, 50),   # the proposal matching at 800x1333
    ("empty_image", 2, 22_223, 50),
    ("masked", 1, 88_750, 50),   # and at 1600x2666
])
def test_large_n_path_against_scipy(kind, B, N, M):
    """Past ``MAX_SLOTS`` a CPU cost takes ``plain_auction`` as every CPU
    cost does: each image's assignment within the auction's bound (M *
    eps) of the optimum, and equal to the optimal one (the costs have no
    ties)."""
    assert N + M > cuda_matcher.MAX_SLOTS
    cost, active = _costs(kind, B, N, M, seed=N + M)
    got, conv = auction_assignment(cost, active, eps=EPS, return_state=True)
    assert conv.all()
    for b in range(B):
        cols = (np.arange(M) if active is None
                else np.flatnonzero(active[b].numpy()))
        c = cost[b][:, cols].double().numpy()
        rows, order = linear_sum_assignment(c)
        best = c[rows, order].sum()
        q = got[b, cols].numpy()
        assert len(set(q.tolist())) == len(cols)
        assert c[q, np.arange(len(cols))].sum() <= best + len(cols) * EPS
        assert np.array_equal(q[order], rows)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N", [("uniform", 22_223), ("masked", 22_223),
                                    ("ties", 22_223),
                                    ("empty_image", 22_223),
                                    ("masked", 88_750)])
def test_large_n_kernels_against_the_whole_auction(device, kind, N):
    """At 88,750 queries (1600x2666) a column's keys outgrow shared
    memory and the select kernel reads them from the L2 each pass."""
    cost, active = _costs(kind, 2, N, 50, seed=7)
    cost = cost.to(device)
    active = None if active is None else active.to(device)
    want_q, want_conv = plain_auction(cost, active, EPS, 2000)
    before = (cuda_auction_large.LAUNCHES, cuda_matcher.LAUNCHES)
    q, conv, rounds = cuda_auction_large.auction(cost, active, EPS, 2000)
    assert torch.equal(q, want_q) and torch.equal(conv, want_conv)
    assert conv.all() and (rounds >= (kind != "empty_image")).all()
    got = auction_assignment(cost, active)
    assert torch.equal(got, want_q)
    assert (cuda_auction_large.LAUNCHES, cuda_matcher.LAUNCHES) == (
        before[0] + 2, before[1])
    # captured in a CUDA graph and replayed on other costs: no host sync
    from msda_tpu_torch.utils.graphs import graphed

    solve = graphed(lambda c: auction_assignment(c, active,
                                                 return_state=True))
    for seed in (8, 9, 10):
        other = _costs(kind, 2, N, 50, seed=seed)[0].to(device)
        got, conv = solve(other)
        want = plain_auction(other, active, EPS, 2000)
        assert torch.equal(got, want[0]) and torch.equal(conv, want[1])
    assert solve.stats()["replays"] == 2
