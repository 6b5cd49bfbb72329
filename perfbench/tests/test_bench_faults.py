"""Whole runs at the tiny size on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: ``correct`` has to come
out true for the sound program and false for each fault the cell can
have."""

from __future__ import annotations

import pytest
import torch

import msda_tpu_torch
import msda_tpu_torch.models as models
import msda_tpu_torch.parallel as parallel

import tiny

SERVE = "ddetr-refine.serve-bf16-coco8"
TRAIN = "ddetr-refine.train-f32-800x1333"
OPS = ["msda-op-ddetr.enc-f32-800x1333", "msda-op-ddetr.enc-f32-1600x2666"]


@pytest.mark.parametrize("cell", [SERVE, TRAIN, *OPS])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace):
    result = tiny.run(cell, trace=trace)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["failed"] == 0
    assert result["attempted"] >= 1


def _serve_with(monkeypatch, alter):
    real = models.postprocess

    def postprocess(*args, **kwargs):
        return alter(real(*args, **kwargs))

    monkeypatch.setattr(models, "postprocess", postprocess)
    return tiny.run(SERVE)


def test_serve_altered_label_is_caught(monkeypatch):
    def alter(det):
        det["labels"] = det["labels"].clone()
        det["labels"][0, 0] = (det["labels"][0, 0] + 1) % 5
        return det

    assert not _serve_with(monkeypatch, alter)["correct"]


def test_serve_altered_box_is_caught(monkeypatch):
    def alter(det):
        det["boxes"] = det["boxes"].clone()
        det["boxes"][1, 3, 2] += 5.0  # a tenth of the image's side
        return det

    assert not _serve_with(monkeypatch, alter)["correct"]


def test_serve_half_batch_left_out_is_caught(monkeypatch):
    def alter(det):
        return {k: torch.cat([v[:1], v[:1]]) for k, v in det.items()}

    assert not _serve_with(monkeypatch, alter)["correct"]


def test_train_state_left_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    result = tiny.run(TRAIN)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out_is_caught(monkeypatch):
    real = parallel.make_train_step

    def make_train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(pyramid, targets):
            return step([f[:1] for f in pyramid],
                        {k: v[:1] for k, v in targets.items()})
        return half

    monkeypatch.setattr(parallel, "make_train_step", make_train_step)
    assert not tiny.run(TRAIN)["correct"]


def _op_with(monkeypatch, alter):
    real = msda_tpu_torch.multiscale_deformable_attention

    def op(*args, **kwargs):
        return alter(real(*args, **kwargs))

    monkeypatch.setattr(msda_tpu_torch, "multiscale_deformable_attention", op)
    return tiny.run(OPS[0])


def test_op_altered_output_is_caught(monkeypatch):
    def alter(out):
        bump = torch.zeros_like(out)
        bump[0, 3, 1, 2] = 1e-3 * out.detach().abs().max()
        return out + bump

    result = _op_with(monkeypatch, alter)
    assert not result["correct"]
    assert result["checks"]["out_err"]["value"] > result["checks"][
        "out_err"]["limit"]


def test_op_altered_gradient_is_caught(monkeypatch):
    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            g[0, 0] *= 1.001
            return g

    def alter(out):
        return Scale.apply(out)

    result = _op_with(monkeypatch, alter)
    assert not result["correct"]


def test_op_half_batch_left_out_is_caught(monkeypatch):
    def alter(out):
        return torch.cat([out[:1], out[:1].detach() * 0 + out[1:].detach()])

    assert not _op_with(monkeypatch, alter)["correct"]
