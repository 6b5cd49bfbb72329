"""The plain reference against tiny computations by hand, against autograd,
and against the program at a tiny size on the CPU (where the program runs
its own plain versions)."""

from __future__ import annotations

import itertools
import json

import pytest
import torch

from perfbench import harness, inputs
from perfbench.reference import adamw, detr, loss, msda

import tiny

CFG = dict(json.loads((harness.ROOT / "perfbench" / "configs"
                       / "ddetr-refine.json").read_text()), **tiny.DETECTOR)


def _bilinear_by_hand(img, shapes, pts, wts, padding_mode):
    """The op point by point: four neighbours, each weighted by its
    bilinear weight, read as zero outside the level (``zeros``) or at the
    nearest edge pixel (``border``)."""
    B, I, H, C = img.shape  # noqa: E741
    _, N, _, L, P, _ = pts.shape
    start = list(itertools.accumulate([0] + [h * w for h, w in shapes]))
    out = torch.zeros((B, N, H, C), dtype=torch.float64)
    for b, n, h, lvl, p in itertools.product(*map(range, (B, N, H, L, P))):
        hh, ww = shapes[lvl]
        x = float(pts[b, n, h, lvl, p, 0]) * ww - 0.5
        y = float(pts[b, n, h, lvl, p, 1]) * hh - 0.5
        x0, y0 = int(torch.floor(torch.tensor(x))), int(
            torch.floor(torch.tensor(y)))
        for cy, cx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
            w = (1 - abs(x - cx)) * (1 - abs(y - cy))
            if not (0 <= cx < ww and 0 <= cy < hh):
                if padding_mode == "zeros":
                    continue
                cx, cy = min(max(cx, 0), ww - 1), min(max(cy, 0), hh - 1)
            out[b, n, h] += (float(wts[b, n, h, lvl, p]) * w
                             * img[b, start[lvl] + cy * ww + cx, h].double())
    return out


def _op_inputs(seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    shapes = ((3, 4), (2, 2))
    img = torch.randn((2, 16, 2, 3), generator=g, dtype=dtype)
    pts = torch.rand((2, 5, 2, 2, 3, 2), generator=g, dtype=dtype) * 1.3 - 0.15
    wts = torch.rand((2, 5, 2, 2, 3), generator=g, dtype=dtype)
    og = torch.randn((2, 5, 2, 3), generator=g, dtype=dtype)
    return img, shapes, pts, wts, og


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_msda_against_bilinear_by_hand(padding_mode):
    img, shapes, pts, wts, _ = _op_inputs()
    got = msda.msda(img, shapes, pts, wts, padding_mode)
    assert torch.allclose(got, _bilinear_by_hand(img, shapes, pts, wts,
                                                 padding_mode), atol=1e-12)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_written_out_gradients_against_autograd(padding_mode):
    img, shapes, pts, wts, og = _op_inputs(1)
    leaves = [t.clone().requires_grad_() for t in (img, pts, wts)]
    out = msda.msda(leaves[0], shapes, leaves[1], leaves[2], padding_mode)
    want = torch.autograd.grad(out, leaves, og)
    got = msda.msda_with_grads(img, shapes, pts, wts, og, padding_mode,
                               chunk=2)
    assert torch.allclose(got[0], out.detach(), atol=1e-12)
    for g, w in zip(got[1:], want):
        assert torch.allclose(g, w, atol=1e-10)


def test_detector_against_the_program_on_the_cpu():
    from perfbench import program

    weights = inputs.detector_weights(CFG, 7, "cpu")
    pyramid = inputs.pyramid(CFG, (32, 48), 2, inputs.generator(7, "cpu", "p"),
                             "cpu")
    model = program.detector(CFG, weights, "cpu").eval()
    with torch.no_grad():
        want = model(pyramid, program.shapes_of(pyramid))
        got = detr.forward(weights, CFG, pyramid)
    for key in ("logits", "boxes"):
        assert torch.allclose(got[key], want[key], atol=1e-5), key
    for a, b in zip(got["aux"], want["aux"]):
        assert torch.allclose(a["logits"], b["logits"], atol=1e-5)


def test_weights_are_the_programs_parameters_and_follow_the_seed():
    from perfbench import program

    weights = inputs.detector_weights(CFG, 7, "cpu")
    model = program.detector(CFG, weights, "cpu")
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    assert all(params[n].shape == weights[n].shape for n in weights)
    again = inputs.detector_weights(CFG, 7, "cpu")
    other = inputs.detector_weights(CFG, 8, "cpu")
    assert all(torch.equal(weights[n], again[n]) for n in weights)
    assert not torch.equal(weights["input_proj.0.weight"],
                           other["input_proj.0.weight"])
    # the official initialisation: sampling offsets on the per-head grid,
    # uniform attention, the focal prior; the weights it zeroes and
    # training moves (the offset projection, the box heads) small
    bias = weights["encoder_layers.0.msda.query_input_proj.bias"].view(
        2, 2, 2, 3)
    assert torch.equal(bias[0, 0, :, :2], torch.tensor([[1.0, 0.0],
                                                        [2.0, 0.0]]))
    assert not bias[..., 2].any()
    for name in ("encoder_layers.0.msda.query_input_proj.weight",
                 "box_refine.0.weight", "box_head.weight"):
        w = weights[name]
        assert w.any() and w.abs().max() <= inputs.MOVED / w.shape[1] ** 0.5
    assert not weights["box_head.bias"].any()
    assert torch.allclose(weights["class_head.bias"],
                          torch.full((5,), -4.59511985))


def test_loss_and_matcher_against_the_program_on_the_cpu():
    from msda_tpu_torch.parallel import detection_loss
    from msda_tpu_torch.parallel.matcher import plain_auction

    g = torch.Generator().manual_seed(3)
    traffic = {"batch": 2, "target_slots": 6, "real_targets": [2, 4],
               "box_wh": [0.05, 0.5]}
    targets = inputs.targets(CFG, traffic, g, "cpu")
    out = {"logits": torch.randn((2, 12, 5), generator=g),
           "boxes": torch.rand((2, 12, 4), generator=g) * 0.5 + 0.2}
    out["aux"] = [{"logits": out["logits"] * 0.5, "boxes": out["boxes"]}]
    lc = CFG["loss"]
    want = detection_loss(out, targets, matcher="auction",
                          class_loss="focal", aux_weight=1.0,
                          l1_weight=5.0, giou_weight=2.0)
    assert torch.allclose(loss.detection_loss(out, targets, lc), want,
                          rtol=1e-6)
    cost = torch.rand((3, 12, 6), generator=g)
    active = torch.rand((3, 6), generator=g) > 0.3
    assert torch.equal(loss.auction(cost, active, 1e-3, 2000),
                       plain_auction(cost, active, 1e-3, 2000)[0])


def test_adamw_against_torch():
    g = torch.Generator().manual_seed(4)
    p = {"a": torch.randn((3, 4), generator=g), "b": torch.randn(5,
                                                                 generator=g)}
    q = [t.clone().requires_grad_() for t in p.values()]
    mine = adamw.AdamW(p, 2e-4, 1e-4)
    torch_opt = torch.optim.AdamW(q, lr=2e-4, weight_decay=1e-4)
    for _ in range(3):
        grads = {k: torch.randn(t.shape, generator=g) for k, t in p.items()}
        mine.step(grads)
        for t, gr in zip(q, grads.values()):
            t.grad = gr
        torch_opt.step()
    for a, b in zip(p.values(), q):
        assert torch.allclose(a, b.detach(), atol=1e-7)


def test_fp8_rounding_keeps_four_significant_bits():
    x = torch.tensor([1.0, 1.0625, 1.1, -300.0, 448.0])
    got = detr.fp8(x)
    assert got[-1] == 448.0 and got[0] == pytest.approx(1.0, rel=0.07)
    assert (got - x).abs().max() / x.abs().max() <= 2 ** -4
