"""Device spans inside CUDA graph replays (``utils.profile.annotate``'s
markers, ``csrc/msda_span.cu``), on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them:
the markers are CUDA kernels with no CPU mode.  The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_span_markers.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from msda_tpu_torch.utils import annotate, graphed, profile

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ("encoder", "decoder", "postprocess")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span markers are CUDA kernels")
    return torch.device("cuda")


def _layered(weight):
    """A serving function of three layers, each a few ms of products on
    ``weight``, over a small input (so that the copies in and out of the
    graph are a small share of the replay)."""
    def serve(x):
        with annotate("encoder"):
            h = weight @ weight * x.sum()
            h = h @ weight
        with annotate("decoder"):
            h = torch.tanh(h @ weight)
        with annotate("postprocess"):
            return (h @ weight).amax(-1)[:8]
    return serve


def test_replay_carries_each_layer_as_a_device_span(device, tmp_path):
    """A graphed function's layer spans, replayed under ``profile.trace``,
    read a positive device time each, and together all but the replay's
    copies and markers of its busy time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(0)
    weight = torch.randn(2048, 2048, device=device, generator=g) / 64
    x = torch.randn(16, device=device, generator=g)
    serve = graphed(_layered(weight))
    for _ in range(3):  # the warm-up, the capture and a replay, a replay
        want = serve(x)
    torch.cuda.synchronize()
    with profile.trace(tmp_path / "trace") as t:
        got = serve(x)
    assert torch.equal(got, want)
    spans = t.span_ms(device=True)  # graphed's host spans' device ranges too
    assert all(spans[name] > 0 for name in LAYERS)
    busy = t.busy_ms()
    assert sum(spans[name] for name in LAYERS) == pytest.approx(busy,
                                                                rel=0.05)
    markers = {name: n for name, n in t.kernel_counts().items()
               if "msda_span<" in name}
    assert sorted(markers.values()) == [1] * 6
    assert {f"void msda_span<{name}, {edge}>()" for name in LAYERS
            for edge in ("begin", "end")} == set(markers)
    assert serve.stats()["replays"] == 3


def test_every_layer_name_marks_its_own_work(device, tmp_path):
    """A replay through all of ``DEVICE_SPANS``, the i-th span doing i + 1
    products: each name's begin and end markers once, and device times
    that rise in that order, so that no span reads another's markers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(1)
    weight = torch.randn(2048, 2048, device=device, generator=g) / 64

    def layers(x):
        h = weight * x.sum()
        for i, name in enumerate(profile.DEVICE_SPANS):
            with annotate(name):
                for _ in range(i + 1):
                    h = h @ weight
        return h[:8, :8]

    step = graphed(layers)
    x = torch.randn(16, device=device, generator=g)
    for _ in range(3):
        want = step(x)
    torch.cuda.synchronize()
    with profile.trace(tmp_path / "trace") as t:
        got = step(x)
    assert torch.equal(got, want)
    markers = {name: n for name, n in t.kernel_counts().items()
               if "msda_span<" in name}
    assert markers == {f"void msda_span<{name}, {edge}>()": 1
                       for name in profile.DEVICE_SPANS
                       for edge in ("begin", "end")}
    spans = t.span_ms(device=True)
    times = [spans[name] for name in profile.DEVICE_SPANS]
    assert times == sorted(times) and times[0] > 0, times


def test_eager_calls_launch_no_marker(device, tmp_path):
    """Outside a capture a layer's span is a host span: the eager call's
    trace holds no marker."""
    weight = torch.randn(256, 256, device=device)
    fn = _layered(weight)
    fn(torch.ones(4, device=device))
    with profile.trace(tmp_path / "trace") as t:
        fn(torch.ones(4, device=device))
    assert not any("msda_span<" in name for name in t.kernel_counts())
    assert set(t.span_ms()) >= set(LAYERS)


# A fresh process: the package imported, then a graphed function with layer
# spans warmed up, captured and replayed under the profiler, with every
# build, library load and ``ctypes.CDLL`` recorded along with whether the
# current stream was capturing then.
_FRESH = r"""
import ctypes, json, sys, tempfile
import torch
import msda_tpu_torch
from msda_tpu_torch.ops import _build
from msda_tpu_torch.utils import annotate, graphed, profile

calls = []

def recorded(name, real):
    def wrapper(*args, **kwargs):
        calls.append((name, torch.cuda.is_current_stream_capturing()))
        return real(*args, **kwargs)
    return wrapper

_build.build = recorded("build", _build.build)
_build.load_library = recorded("load_library", _build.load_library)
ctypes.CDLL = recorded("CDLL", ctypes.CDLL)

def serve(x):
    with annotate("encoder"):
        h = torch.relu(x @ x)
    with annotate("decoder"):
        return (h @ x).sum(-1)

step = graphed(serve)
x = torch.randn(512, 512, device="cuda")
step(x)
step(x)
with profile.trace(tempfile.mkdtemp()) as t:
    step(x)
print(json.dumps({"calls": calls, "spans": t.span_ms(device=True)}))
"""


def test_a_fresh_capture_builds_and_loads_nothing_under_capture(device):
    """Right after import, a new signature's warm-up loads the marker
    library, so that its capture builds and loads nothing (lazy module
    loading on) and its replay carries the spans."""
    env = dict(os.environ, CUDA_MODULE_LOADING="LAZY")
    run = subprocess.run([sys.executable, "-c", _FRESH], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["calls"], "the warm-up loaded no library"
    assert not [c for c in out["calls"] if c[1]], out["calls"]
    assert ["load_library", False] in out["calls"]
    assert all(out["spans"][name] > 0 for name in ("encoder", "decoder"))
    assert "postprocess" not in out["spans"]
