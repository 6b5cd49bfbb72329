"""The DINO training cell (``drivers/traindn.py``): its pieces found by name,
its reference's imports, whole runs at the tiny size on the CPU, sound and
with faults planted, against the cell's limits, the refusal of a program
without the DINO form, and on the card its TF32 control's readings at the
tiny size."""

from __future__ import annotations

import pytest
import torch

import msda_tpu_torch.models as models
from msda_tpu_torch.models import denoising
from perfbench import calibrate, harness, inputs_dino
from perfbench.drivers import traindn

import test_bench_imports
import tiny

CELL = "dino-5scale.traindn-f32-800x1333"
SEED = 2 ** 31 + 77


def _fails(readings: dict, limits: dict) -> list[str]:
    return [n for n, limit in limits.items() if not readings[n] <= limit]


def test_the_driver_takes_the_mix_and_its_metrics():
    cell = harness.find_cell(harness.ROOT, CELL)
    assert cell.traffic["driver"] == "traindn"
    assert harness.unsupported(cell.config, cell.traffic, cell.driver) == []
    assert set(cell.limits) == {"grad_gap", "grad_err", "change_gap",
                                "selection_gap", "proposal_err", "dn_err",
                                "draw_outside", "draw_z"}
    assert {m["name"] for m in cell.per_layer} >= {
        "dn_queries_device_ms.train", "dn_loss_device_ms.train",
        "mfu_pct.traindn", "proposals_device_ms.train",
        "graph_miss_pct.train", "idle_pct.train"}
    assert "mfu_pct.train2s" not in cell.readers
    assert cell.config["reduced"] == []


def test_the_reference_imports_nothing_of_the_program():
    for name in ("detr_dino.py", "loss_dino.py"):
        path = harness.ROOT / "perfbench" / "reference" / name
        assert not test_bench_imports._imports(path) & {
            "msda_tpu_torch", "msda_tpu", "jax", "jaxlib", "flax", "optax"}


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    result = tiny.run(CELL, trace=trace, seed=SEED)
    assert result["correct"], result["checks"]
    assert result["checks"]["selection_gap"]["value"] == 0.0
    if trace:
        assert "mfu_pct.traindn" in result["metrics"]


def test_tiny_readings_separate_the_program_from_the_faults():
    """The program passes every limit; half the batch left out, the state
    left unchanged, the group mask dropped, look forward twice detached,
    the denoising queries without noise and each wrong law of the draws
    each fail one at least, the draws' faults ``draw_z`` or
    ``draw_outside``.  (TF32 does nothing on the CPU: its control is the
    card's, below.)"""
    cell = tiny.shrink(harness.find_cell(harness.ROOT, CELL))
    got = calibrate.readings(cell, SEED, 0.3, torch.device("cpu"))
    assert not _fails(got["program"], cell.limits), got["program"]
    assert set(got["faults"]) == {"half_batch", "unchanged", "mask_dropped",
                                  "detached", "noise_off",
                                  *traindn.DRAW_FAULTS}
    for name, readings in got["faults"].items():
        assert _fails(readings, cell.limits), (name, readings)
    assert "dn_err" in _fails(got["faults"]["mask_dropped"], cell.limits)
    assert "dn_err" in _fails(got["faults"]["noise_off"], cell.limits)
    for name in traindn.DRAW_FAULTS:
        assert set(_fails(got["faults"][name], cell.limits)) <= {
            "draw_z", "draw_outside"}, name


def test_a_program_drawing_signs_in_0_1_is_caught(monkeypatch):
    """A program whose box-noise signs are 0 or 1: the reference noises the
    same draws, so only the draws' own checks can see it, and they do."""
    real = denoising.draw

    def draw(*args, **kwargs):
        out = real(*args, **kwargs)
        return dict(out, sign=(out["sign"] + 1) / 2)

    monkeypatch.setattr(denoising, "draw", draw)
    result = tiny.run(CELL, seed=SEED)
    assert not result["correct"]
    assert {n for n, c in result["checks"].items()
            if c["value"] > c["limit"]} == {"draw_outside", "draw_z"}


def test_a_program_without_the_group_mask_is_caught(monkeypatch):
    """A program whose DN queries and matching queries all see each other:
    the reference noises the same draws behind the mask, and the DN outputs
    and the gradients part."""
    monkeypatch.setattr(
        denoising, "attention_mask",
        lambda m, groups, q, device=None: torch.zeros(
            (2 * groups * m + q,) * 2, dtype=torch.bool, device=device))
    result = tiny.run(CELL, seed=SEED)
    assert not result["correct"]
    assert result["checks"]["dn_err"]["value"] > \
        result["checks"]["dn_err"]["limit"]


def test_a_wrong_selection_is_caught(monkeypatch):
    """A program whose mixed query selection takes the next ``num_queries``
    tokens after the best: the reference decodes from that selection, so
    only ``selection_gap`` can see it, and it does."""
    real_forward, real_topk = models.DeformableDetr.forward, torch.topk

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

    monkeypatch.setattr(models.DeformableDetr, "forward", forward)
    result = tiny.run(CELL, seed=SEED)
    assert not result["correct"]
    assert [n for n, c in result["checks"].items()
            if c["value"] > c["limit"]] == ["selection_gap"]


def test_a_program_without_the_dino_form_is_refused(monkeypatch):
    """A detector that refuses ``two_stage="dino"`` (as one from before the
    form was added), or whose DINO form has other parameters: refused
    before any weight is made."""
    real_init = models.DeformableDetr.__init__

    def init(self, *args, two_stage=False, **kwargs):
        if two_stage == "dino":
            raise ValueError("two_stage must be False, True or 'published'")
        real_init(self, *args, two_stage=two_stage, **kwargs)

    monkeypatch.setattr(models.DeformableDetr, "__init__", init)
    with pytest.raises(harness.Refused, match="no DINO form"):
        tiny.run(CELL, seed=SEED)
    monkeypatch.undo()
    real = inputs_dino.detector_spec
    monkeypatch.setattr(inputs_dino, "detector_spec",
                        lambda cfg: real(cfg) + [("pos_trans.weight",
                                                  (512, 512), "xavier")])
    with pytest.raises(harness.Refused, match="not this DINO form"):
        tiny.run(CELL, seed=SEED)


@pytest.mark.cuda
def test_tf32_control_fails_the_limits_at_the_tiny_size():
    """TF32 moves the tiny first step's encoder logits and DN outputs by
    some 1e2 times the program's rounding and more, and fails a forward
    limit; the program passes every limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    cell = tiny.shrink(harness.find_cell(harness.ROOT, CELL))
    got = calibrate.readings(cell, SEED, 0.5, torch.device("cuda", 0))
    assert not _fails(got["program"], cell.limits), got["program"]
    assert {"proposal_err", "dn_err"} & set(_fails(got["control"],
                                                   cell.limits)), got
