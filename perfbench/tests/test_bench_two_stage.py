"""The two-stage training cell (``drivers/train2s.py``): its pieces found by
name, whole runs at the tiny size on the CPU, sound and with faults
planted, against the cell's limits, and on the card its TF32 control's
readings at the tiny size."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

import msda_tpu_torch.parallel as parallel
from msda_tpu_torch.models import DeformableDetr
from perfbench import calibrate, harness, inputs_two_stage

import tiny

CELL = "ddetr-2stage-refine.train2s-f32-800x1333"
SEED = 2 ** 31 + 77


def _fails(readings: dict, limits: dict) -> list[str]:
    return [n for n, limit in limits.items() if not readings[n] <= limit]


def test_the_driver_takes_the_mix_and_refuses_others(tmp_path):
    cell = harness.find_cell(harness.ROOT, CELL)
    assert cell.traffic["driver"] == "train2s"
    assert harness.unsupported(cell.config, cell.traffic, cell.driver) == []
    assert set(cell.limits) == {"grad_gap", "grad_err", "change_gap",
                                "selection_gap", "proposal_err"}
    assert {m["name"] for m in cell.per_layer} >= {
        "proposals_device_ms.train", "proposal_loss_device_ms.train",
        "mfu_pct.train2s", "idle_pct.train"}
    assert "mfu_pct.train" not in cell.readers
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    path = tmp_path / "perfbench" / "traffic" / "train2s-f32-800x1333.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "compute_dtype": "bfloat16"}))
    with pytest.raises(harness.Refused, match="compute_dtype"):
        harness.find_cell(tmp_path, CELL)
    path = tmp_path / "perfbench" / "configs" / "ddetr-2stage-refine.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "two_stage": True}))
    with pytest.raises(harness.Refused, match="two_stage"):
        harness.find_cell(tmp_path, CELL)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    result = tiny.run(CELL, trace=trace, seed=SEED)
    assert result["correct"], result["checks"]
    assert result["checks"]["selection_gap"]["value"] == 0.0
    if trace:
        assert "mfu_pct.train2s" in result["metrics"]


def test_tiny_readings_separate_the_program_from_the_faults():
    """The program passes every limit; half the batch left out and the
    state left unchanged fail one at least; a selection of top-k on logit
    1 fails ``selection_gap``.  (TF32 does nothing on the CPU: its control
    is the card's, below.)"""
    cell = tiny.shrink(harness.find_cell(harness.ROOT, CELL))
    got = calibrate.readings(cell, SEED, 0.3, torch.device("cpu"))
    assert not _fails(got["program"], cell.limits), got["program"]
    assert _fails(got["faults"]["half_batch"], cell.limits)
    assert _fails(got["faults"]["unchanged"], cell.limits)
    assert "selection_gap" in _fails(got["faults"]["wrong_column"],
                                     cell.limits)


def test_a_wrong_selection_is_caught(monkeypatch):
    """A program whose proposal stage takes the next ``num_queries`` after
    the best: the reference decodes from that selection, so only
    ``selection_gap`` can see it, and it does."""
    real_forward, real_topk = DeformableDetr.forward, torch.topk

    def next_block(x, k, *args, **kwargs):
        if x.ndim == 2 and x.shape[1] >= 2 * k:
            top = real_topk(x, 2 * k, *args, **kwargs)
            return torch.return_types.topk((top.values[:, k:],
                                            top.indices[:, k:]))
        return real_topk(x, k, *args, **kwargs)

    def forward(self, *args, **kwargs):
        torch.topk = next_block
        try:
            return real_forward(self, *args, **kwargs)
        finally:
            torch.topk = real_topk

    monkeypatch.setattr(DeformableDetr, "forward", forward)
    result = tiny.run(CELL, seed=SEED)
    assert not result["correct"]
    assert [n for n, c in result["checks"].items()
            if c["value"] > c["limit"]] == ["selection_gap"]


def test_half_batch_left_out_is_caught(monkeypatch):
    real = parallel.make_train_step

    def make_train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(pyramid, targets):
            return step([f[:1] for f in pyramid],
                        {k: v[:1] for k, v in targets.items()})
        return half

    monkeypatch.setattr(parallel, "make_train_step", make_train_step)
    assert not tiny.run(CELL, seed=SEED)["correct"]


def test_a_program_without_the_published_form_is_refused(monkeypatch):
    """A detector whose published form has other parameters (as one from
    before the form was added): refused before any weight is made."""
    real = inputs_two_stage.detector_spec
    monkeypatch.setattr(inputs_two_stage, "detector_spec",
                        lambda cfg: real(cfg) + [("proposal_pos_proj.weight",
                                                  (256, 4), "xavier")])
    with pytest.raises(harness.Refused, match="published two-stage"):
        tiny.run(CELL, seed=SEED)


@pytest.mark.cuda
def test_tf32_control_fails_the_limits_at_the_tiny_size():
    """TF32 moves the tiny first step's proposal logits by some 1e2 times
    the program's rounding and more, and fails ``proposal_err``'s limit;
    the program passes every limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    cell = tiny.shrink(harness.find_cell(harness.ROOT, CELL))
    got = calibrate.readings(cell, SEED, 0.5, torch.device("cuda", 0))
    assert not _fails(got["program"], cell.limits), got["program"]
    assert (got["control"]["proposal_err"]
            > 100 * got["program"]["proposal_err"]), got
    assert "proposal_err" in _fails(got["control"], cell.limits), got
