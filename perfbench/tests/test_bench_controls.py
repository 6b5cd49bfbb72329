"""The controls on the card, at the cells' own sizes (a short window, one
seed): the program passes every limit of its cell, and the reference put
in its place one precision below the configuration's fails at least one
(``calibrate.py`` has the controls; it reads a dozen seeds and more).
For the training cell each planted fault fails one too.  Skips without
a card."""

from __future__ import annotations

import pytest
import torch

from perfbench import calibrate, harness

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


def _fails(readings: dict, limits: dict) -> bool:
    return any(not readings[n] <= limit for n, limit in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the CUDA kernels")
    cell = harness.find_cell(harness.ROOT, name)
    got = calibrate.readings(cell, 2 ** 31 + 101, 1.0,
                             torch.device("cuda", 0))
    assert not _fails(got["program"], cell.limits), got["program"]
    assert _fails(got["control"], cell.limits), got["control"]
    for fault, readings in got["faults"].items():
        assert _fails(readings, cell.limits), (fault, readings)
