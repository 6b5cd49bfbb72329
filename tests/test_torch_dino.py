"""The DINO form of the detector (``DeformableDetr(two_stage="dino")``), its
denoising queries (``models/denoising.py``) and its loss, against the
benchmark's plain reference (``perfbench/reference/detr_dino.py``,
``loss_dino.py``), written apart from the port.

On the CPU, at ``utils.DEFAULT_CFG``'s widths (4 heads of 32 channels, 3
points, 80 queries) over a 5-level 16-base pyramid (341 tokens), two
encoder and two decoder layers: the forward of every layer, the interm
outputs and the denoising queries' outputs, the loss and every parameter's
gradient, the reference noising the port's own draws and decoding from its
selection; DINO's group and pad rule and its attention mask at several
target counts; the matching queries' outputs blind to the denoising
queries' inputs; look forward twice (the last layer's box loss reaching
the box MLP through the layer before's box, which a detached variant
does not); the train step's eager call against its wrapped step.  The
file imports no JAX.

Tolerances as ``test_torch_two_stage_published.py``'s: the forward 1e-5 of
max(1, |ref|), the loss 1e-5 relative, gradients 1e-4 of each parameter's
largest reference gradient floored at the median parameter's.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from msda_tpu_torch.models import DeformableDetr, denoising, init_parameters
from msda_tpu_torch.parallel import detection_loss, make_train_step
from msda_tpu_torch.parallel import train as train_module
from perfbench import inputs, inputs_dino
from perfbench.drivers import train2s, traindn
from perfbench.reference import detr_dino as ref_detr
from perfbench.reference import loss_dino as ref_loss
from utils import DEFAULT_CFG, make_pyramid_shapes

ROOT = Path(__file__).resolve().parents[1]


def _cfg() -> dict:
    """The benchmark's DINO configuration at DEFAULT_CFG's widths."""
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "dino-5scale.json").read_text())
    H, C, P = (DEFAULT_CFG[k] for k in "HCP")
    cfg.update(emb_dim=H * C, num_heads=H, head_dim=C, num_levels=5,
               num_points=P, num_encoder_layers=2, num_decoder_layers=2,
               ffn_dim=256, num_queries=DEFAULT_CFG["N"], num_classes=7,
               in_channels=[8, 16, 24, 32, 32], strides=[4, 8, 16, 32, 64])
    return cfg


def _model(cfg, weights=None):
    model = DeformableDetr(
        num_classes=cfg["num_classes"], in_channels=tuple(cfg["in_channels"]),
        emb_dim=cfg["emb_dim"], num_heads=cfg["num_heads"],
        num_points=cfg["num_points"], num_queries=cfg["num_queries"],
        num_encoder_layers=cfg["num_encoder_layers"],
        num_decoder_layers=cfg["num_decoder_layers"], ffn_dim=cfg["ffn_dim"],
        with_box_refinement=True, two_stage="dino")
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model


def _batch(cfg, seed, real=(3, 6)):
    rng = np.random.default_rng(seed)
    B = DEFAULT_CFG["B"]
    shapes = [tuple(map(int, s)) for s in make_pyramid_shapes(5)]
    pyramid = [torch.from_numpy(rng.standard_normal((B, h, w, c),
                                                    dtype=np.float32))
               for (h, w), c in zip(shapes, cfg["in_channels"])]
    targets = inputs.targets(cfg, {"batch": B, "target_slots": 8,
                                   "real_targets": list(real),
                                   "box_wh": [0.05, 0.5]},
                             torch.Generator().manual_seed(seed), "cpu")
    m = int(targets["mask"].sum(1).max())
    return pyramid, tuple(shapes), targets, m


def _program_loss(out, targets, cfg):
    lc = cfg["loss"]
    return detection_loss(out, targets, matcher=lc["matcher"],
                          class_loss=lc["class_loss"],
                          aux_weight=lc["aux_weight"],
                          enc_weight=lc["enc_weight"],
                          l1_weight=lc["l1_weight"],
                          giou_weight=lc["giou_weight"],
                          matcher_rounds=lc["matcher_rounds"],
                          class_cost_weight=lc["class_cost"])


def _close(got, want, tol=1e-5):
    got, want = got.detach(), want.detach()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


def _grads(loss, named):
    """Each of ``named``'s gradients, zeros where none reaches it (the
    label table without denoising queries)."""
    names = list(named)
    grads = torch.autograd.grad(loss, [named[n] for n in names],
                                allow_unused=True)
    return {n: torch.zeros_like(named[n]) if g is None else g
            for n, g in zip(names, grads)}


def _grads_close(grads, ref_grads):
    floor = float(np.median([float(g.abs().max())
                             for g in ref_grads.values()]))
    for name, g in ref_grads.items():
        assert float((grads[name] - g).abs().max()) <= 1e-4 * max(
            float(g.abs().max()), floor), name


@pytest.mark.parametrize("denoise", [True, False], ids=["dn", "no_dn"])
def test_dino_form_against_the_plain_reference(denoise):
    torch.set_num_threads(1)
    cfg = _cfg()
    weights = inputs_dino.detector_weights(cfg, 11, "cpu")
    model = _model(cfg, weights)
    pyramid, shapes, targets, m = _batch(cfg, 3)
    assert sum(h * w for h, w in shapes) == 341
    torch.manual_seed(5)
    out = (model(pyramid, shapes, targets=targets, max_targets=m) if denoise
           else model(pyramid, shapes))
    loss = _program_loss(out, targets, cfg)
    grads = _grads(loss, dict(model.named_parameters()))

    params = {n: t.clone().requires_grad_() for n, t in weights.items()}
    own = ref_detr.forward(weights, cfg, pyramid)["top_idx"]
    ref = ref_detr.forward(params, cfg, pyramid,
                           top_idx=out["proposals"]["top_idx"],
                           targets=targets,
                           draws=out["dn"]["draws"] if denoise else None)
    ref_l = ref_loss.detection_loss(ref, targets, cfg["loss"])
    ref_grads = _grads(ref_l, params)

    assert [set(a.tolist()) for a in out["proposals"]["top_idx"]] == [
        set(a.tolist()) for a in own]
    assert train2s.selection_gap(
        {"top_idx": [out["proposals"]["top_idx"]]},
        {"logit0": [ref["scores"].detach()]}) == 0.0
    _close(out["proposals"]["logits"], ref["enc_logits"])
    for key in ("logits", "boxes"):
        _close(out[key], ref[key])
        _close(out["interm"][key], ref["interm"][key])
    assert len(out["aux"]) == len(ref["aux"]) == 1
    for a, b in zip(out["aux"], ref["aux"]):
        _close(a["logits"], b["logits"])
        _close(a["boxes"], b["boxes"])
    if denoise:
        groups, pad = denoising.cdn_shape(m)
        assert out["dn_meta"] == ref["dn_meta"] == {
            "max_targets": m, "groups": groups, "pad": pad}
        assert out["dn"]["logits"].shape == (2, pad, cfg["num_classes"])
        for a, b in zip([out["dn"], *out["dn"]["aux"]],
                        [ref["dn"], *ref["dn"]["aux"]]):
            _close(a["logits"], b["logits"])
            _close(a["boxes"], b["boxes"])
    else:
        assert "dn" not in out and "dn_meta" not in out
    assert float(loss.detach()) == pytest.approx(float(ref_l.detach()),
                                               rel=1e-5)
    assert set(grads) == set(ref_grads) == set(weights)
    reached = ["enc_output.weight", "enc_class_head.weight",
               "enc_box_head.layers.2.weight", "query_embedding",
               "ref_point_head.layers.0.weight", "decoder_norm.weight",
               "box_head.layers.0.weight"]
    if denoise:
        reached.append("label_enc.weight")
    for name in reached:
        assert ref_grads[name].abs().max() > 0, name
    _grads_close(grads, ref_grads)


@pytest.mark.parametrize("m", [0, 1, 5, 6, 7, 8, 9, 50, 101, 250])
def test_group_and_pad_rule_and_mask(m):
    """DINO's rule: 2 * 100 // (2 m) groups (at least 1) of 2 m queries,
    the pads of the benchmark's 5-9 real targets 200, 192, 196, 192, 198;
    the mask as the official loop builds it."""
    groups, pad = denoising.cdn_shape(m)
    if m == 0:
        assert (groups, pad) == (0, 0)
        return
    assert groups == ref_detr.dn_groups(m, 100)
    assert pad == 2 * groups * m
    assert pad == {1: 200, 5: 200, 6: 192, 7: 196, 8: 192, 9: 198,
                   50: 200, 101: 202, 250: 500}[m]
    Q = 7
    got = denoising.attention_mask(m, groups, Q)
    want = ref_detr.attention_mask(m, groups, Q, "cpu")
    assert torch.equal(got, want)
    assert not got[pad:, pad:].any() and got[pad:, :pad].all()


def test_group_rule_below_fifty_keeps_twice_the_number():
    """``prepare_for_cdn`` divides by 2 m only from 100 copies on: the
    reference keeps 2 * 20 groups at 20, and the port's settings, DINO's
    published ones as the configuration states them, lie past that
    branch."""
    assert ref_detr.dn_groups(3, 20) == 40
    dn = _cfg()["dn"]
    assert (denoising.DN_NUMBER, denoising.LABEL_NOISE_RATIO,
            denoising.BOX_NOISE_SCALE) == (
        dn["number"], dn["label_noise_ratio"], dn["box_noise_scale"])
    assert 2 * denoising.DN_NUMBER >= 100


def test_draws_follow_their_laws_at_the_cells_shapes():
    """``denoising.draw`` at the DINO cell's batch, classes and counts of
    real targets: every draw in its range and every mean and spread within
    the cell's ``draw_z`` limit of its law's, which signs in {0, 1} fail."""
    limits = json.loads((ROOT / "perfbench" / "limits" /
                         "dino-5scale.traindn-f32-800x1333.json").read_text())
    torch.manual_seed(25)
    draws = [denoising.draw(2, denoising.cdn_shape(m)[0], m, 91, "cpu")
             for m in (5, 6, 7, 8, 9)]
    got = traindn.draw_checks(draws, 91)
    assert got["draw_outside"] == 0 and got["draw_z"] <= limits["draw_z"]
    wrong = traindn.draw_checks(
        [dict(d, sign=(d["sign"] + 1) / 2) for d in draws], 91)
    assert wrong["draw_outside"] > 0 and wrong["draw_z"] > limits["draw_z"]


def test_dn_targets_follow_the_real_slots():
    """Real targets in any slots: the r-th real one is query 2 g m + r's
    target in every group, and the rest no object."""
    targets = {"labels": torch.tensor([[4, 1, 2, 3], [0, 5, 6, 2]]),
               "boxes": torch.rand(2, 4, 4),
               "mask": torch.tensor([[0.0, 1.0, 0.0, 1.0],
                                     [1.0, 0.0, 0.0, 0.0]])}
    labels, boxes, positive = denoising.dn_targets(targets, 2, 3, 9)
    assert labels.shape == positive.shape == (2, 12)
    assert labels[0].tolist() == [1, 3, 9, 9] * 3
    assert labels[1].tolist() == [0, 9, 9, 9] * 3
    assert positive.sum(1).tolist() == [6, 3]
    assert torch.equal(boxes[0, 4], targets["boxes"][0, 1])
    assert torch.equal(boxes[0, 9], targets["boxes"][0, 3])


def test_matching_queries_are_blind_to_the_denoising_queries(monkeypatch):
    """The matching queries' outputs do not move when the DN queries'
    labels and boxes do (the group mask); with the mask dropped they do."""
    torch.set_num_threads(1)
    cfg = _cfg()
    model = _model(cfg, inputs_dino.detector_weights(cfg, 12, "cpu"))
    pyramid, shapes, targets, m = _batch(cfg, 4)
    with torch.no_grad():
        torch.manual_seed(1)
        a = model(pyramid, shapes, targets=targets, max_targets=m)
        torch.manual_seed(2)
        b = model(pyramid, shapes, targets=targets, max_targets=m)
        assert not torch.equal(a["dn"]["draws"]["part"],
                               b["dn"]["draws"]["part"])
        assert not torch.allclose(a["dn"]["boxes"], b["dn"]["boxes"])
        for x, y in zip([a, *a["aux"]], [b, *b["aux"]]):
            assert torch.allclose(x["logits"], y["logits"], rtol=0,
                                  atol=1e-6)
            assert torch.allclose(x["boxes"], y["boxes"], rtol=0, atol=1e-6)
        model._constants.clear()
        monkeypatch.setattr(
            denoising, "attention_mask",
            lambda m, g, q, device=None: torch.zeros(
                (2 * g * m + q, 2 * g * m + q), dtype=torch.bool))
        torch.manual_seed(2)
        c = model(pyramid, shapes, targets=targets, max_targets=m)
        assert not torch.allclose(b["logits"], c["logits"], atol=1e-4)


def test_look_forward_twice_trains_the_layer_before():
    """The last layer's box loss reaches the box MLP through the box the
    layer before updated (undetached): its gradient is the reference's, and
    the reference with that box detached gives another."""
    torch.set_num_threads(1)
    cfg = _cfg()
    weights = inputs_dino.detector_weights(cfg, 13, "cpu")
    model = _model(cfg, weights)
    pyramid, shapes, targets, m = _batch(cfg, 5)
    names = [n for n in weights if n.startswith("box_head.")]
    out = model(pyramid, shapes)
    got = _grads(out["boxes"].sum(), {n: p for n, p in
                                      model.named_parameters()
                                      if n in names})
    want = {}
    for look_twice in (True, False):
        params = {n: t.clone().requires_grad_() for n, t in weights.items()}
        ref = ref_detr.forward(params, cfg, pyramid,
                               top_idx=out["proposals"]["top_idx"],
                               look_twice=look_twice)
        want[look_twice] = _grads(ref["boxes"].sum(),
                                  {n: params[n] for n in names})
    for n in names:
        _close(got[n], want[True][n], 1e-4)
    gap = max(float((want[True][n] - want[False][n]).abs().max()
                    / want[True][n].abs().max()) for n in names)
    assert gap > 0.01


def test_train_step_eager_call_is_its_wrapped_step():
    """On the CPU the step is its wrapped step (no graph): the same seed
    gives the same loss and parameters bitwise, a denoising signature
    included; the step counts its DN queries, the wrapped step none."""
    torch.set_num_threads(1)
    cfg = _cfg()
    weights = inputs_dino.detector_weights(cfg, 14, "cpu")
    pyramid, shapes, targets, m = _batch(cfg, 6)
    runs, counted = [], []
    for wrapped in (False, True):
        model = _model(cfg, weights)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        lc = cfg["loss"]
        step = make_train_step(model, opt, shapes, matcher="auction",
                               class_loss="focal",
                               class_cost_weight=lc["class_cost"])
        call = step.__wrapped__ if wrapped else step
        torch.manual_seed(9)
        before = denoising.BUILT
        losses = [float(call(pyramid, targets, m)) for _ in range(2)]
        counted.append(denoising.BUILT - before)
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert counted == [2 * pyramid[0].shape[0] * denoising.cdn_shape(m)[1],
                       0]


def test_denoising_queries_are_counted(monkeypatch):
    """The train step counts its DN queries on the host at every call, a
    graphed step's replays (which run nothing of the model's Python)
    included; a forward alone counts none."""
    cfg = _cfg()
    model = _model(cfg)
    pyramid, shapes, targets, m = _batch(cfg, 7)

    def replayed(fn, options=None):
        """A stand-in for ``graphed``: the first call runs ``fn``, every
        later one returns its result and runs nothing."""
        kept = []

        def call(*args):
            if not kept:
                kept.append(fn(*args))
            return kept[0]

        call.stats = lambda: {"replays": None}
        return call

    monkeypatch.setattr(train_module, "_param_device",
                        lambda model: torch.device("cuda", 0))
    monkeypatch.setattr(train_module, "_check_capturable", lambda opt: None)
    monkeypatch.setattr(train_module, "graphed", replayed)
    step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                  lr=1e-3),
                           shapes, matcher="auction", class_loss="focal")
    before = denoising.BUILT
    with torch.no_grad():
        model(pyramid, shapes, targets=targets, max_targets=m)
    assert denoising.BUILT == before
    for _ in range(3):
        step(pyramid, targets, m)
    assert denoising.BUILT - before == (3 * pyramid[0].shape[0]
                                        * denoising.cdn_shape(m)[1])
    assert step.stats() == {"replays": None}


def test_init_parameters_draws_the_dino_form_as_published():
    """The box MLPs' last layers zero, both class heads at the prior, the
    label table and the content queries drawn from the generator."""
    cfg = _cfg()
    model = init_parameters(_model(cfg), torch.Generator().manual_seed(3))
    for mlp in (model.box_head, model.enc_box_head):
        assert not mlp.layers[-1].weight.any()
        assert mlp.layers[0].weight.any()
    prior = -math.log(99)
    for head in (model.class_head, model.enc_class_head):
        assert torch.allclose(head.bias, torch.full_like(head.bias, prior))
    again = init_parameters(_model(cfg), torch.Generator().manual_seed(3))
    assert torch.equal(model.label_enc.weight, again.label_enc.weight)
    assert torch.equal(model.query_embedding, again.query_embedding)


def test_other_forms_refuse_the_denoising_arguments():
    cfg = _cfg()
    model = DeformableDetr(num_classes=7, in_channels=(8, 16), emb_dim=32,
                           num_heads=2, num_points=2, num_queries=4,
                           num_encoder_layers=1, num_decoder_layers=1,
                           ffn_dim=32, two_stage="published")
    pyramid, _, targets, m = _batch(cfg, 8)
    with pytest.raises(ValueError, match="dino"):
        model(pyramid[:2], ((16, 16), (8, 8)), targets=targets,
              max_targets=m)
