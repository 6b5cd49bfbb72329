"""The peak-and-residents sweep of ``python -m msda_tpu_torch.memory_report``
on synthetic allocator traces.

The counterparts of ``tests/test_memory_report.py``'s liveness cases that
carry over from scheduled HLO to the CUDA caching allocator's trace
(``torch.cuda.memory._snapshot()["device_traces"]``): the peak and the
blocks live there, largest first; a trace without an allocation raises.
Added for the allocator's trace: frees of blocks from before the trace,
addresses used twice, the actions that change nothing, and the frame
named for a block.  The sweep needs no card; the entry point does.
"""

import pytest
import torch

from msda_tpu_torch import memory_report
from msda_tpu_torch.memory_report import allocating_frame, liveness_report

_OWN = {"filename": "/src/msda_tpu_torch/ops/cuda_bwd.py", "line": 82,
        "name": "msda_bwd"}
_TORCH = {"filename": "/venv/torch/autograd/graph.py", "line": 10,
          "name": "run_backward"}
_NATIVE = {"filename": "??", "line": 0, "name": "torch::unwind::unwind()"}


def _alloc(addr, size, frames=()):
    return {"action": "alloc", "addr": addr, "size": size,
            "frames": list(frames)}


def _free(addr, size, action="free_completed"):
    return {"action": action, "addr": addr, "size": size, "frames": []}


_TRACE = [
    _alloc(0x100, 100),
    _alloc(0x200, 1000, [_NATIVE, _TORCH, _OWN]),
    _free(0x100, 100, "free_requested"),
    _free(0x100, 100),
    _alloc(0x300, 200),
    _alloc(0x400, 50),  # the peak: 1000 + 200 + 50
    _free(0x200, 1000),
    _alloc(0x500, 900),
    _free(0x300, 200),
]


def test_liveness_peak_and_residents():
    peak, index, residents = liveness_report(_TRACE, top=10)
    assert (peak, index) == (1250, 5)
    assert [(size, addr) for size, _, addr in residents] == [
        (1000, 0x200), (200, 0x300), (50, 0x400)]
    assert residents[0][1] == "/src/msda_tpu_torch/ops/cuda_bwd.py:82:msda_bwd"
    sizes = [size for size, _, _ in residents]
    assert sizes == sorted(sizes, reverse=True)
    assert len(liveness_report(_TRACE, top=2)[2]) == 2


def test_liveness_requires_an_allocation():
    with pytest.raises(ValueError, match="no alloc"):
        liveness_report([])
    with pytest.raises(ValueError, match="no alloc"):
        liveness_report([_free(0x100, 100), {"action": "snapshot"}])


def test_frees_of_earlier_blocks_lower_the_level():
    """A block freed that was allocated before the trace began counts
    against the level (the peak is the increase over the start) and is no
    resident."""
    trace = [_free(0x900, 500), _alloc(0x100, 400), _alloc(0x200, 300)]
    peak, index, residents = liveness_report(trace)
    assert (peak, index) == (200, 2)
    assert {addr for _, _, addr in residents} == {0x100, 0x200}


def test_an_address_used_twice():
    trace = [_alloc(0x100, 300), _free(0x100, 300), _alloc(0x100, 700),
             _alloc(0x200, 10)]
    peak, index, residents = liveness_report(trace)
    assert (peak, index) == (710, 3)
    assert [(size, addr) for size, _, addr in residents] == [
        (700, 0x100), (10, 0x200)]


@pytest.mark.parametrize("action", ["segment_alloc", "segment_free",
                                    "free_requested", "segment_map",
                                    "snapshot", "oom"])
def test_other_actions_change_nothing(action):
    event = {"action": action, "addr": 0x100, "size": 10_000, "frames": []}
    base = [_alloc(0x100, 100), _alloc(0x200, 50)]
    assert liveness_report(base + [event]) == liveness_report(base)
    assert liveness_report([event] + base)[0] == 150


@pytest.mark.parametrize("frames,want", [
    ([_NATIVE, _TORCH, _OWN], "/src/msda_tpu_torch/ops/cuda_bwd.py:82:"
                              "msda_bwd"),
    ([_TORCH], "/venv/torch/autograd/graph.py:10:run_backward"),
    ([], "?"),
])
def test_allocating_frame(frames, want):
    assert allocating_frame(frames) == want


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        memory_report.main(["--queries", "10"])
