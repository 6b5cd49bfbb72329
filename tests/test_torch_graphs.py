"""``msda_tpu_torch.utils.graphs.graphed`` (a function captured as a CUDA
graph per input signature and replayed) on the CPU, and the graphed serving
function of the two-stage detector against the JAX model under ``jax.jit``.

A CPU build has no CUDA graph, so the streams and ``torch.cuda.CUDAGraph``
/ ``torch.cuda.graph`` are stubbed as ``tests/test_torch_auction.py`` stubs
them for the train step, and ``graphs._card`` takes the CPU tensors for
CUDA ones.  The stand-in graph keeps what the function under capture
records in it (``_Graph.work``) and runs that again at each replay, as a
CUDA graph replays its kernels on the storage they were captured on.  The
function's one "kernel" counts its launches in ``cuda_fwd.LAUNCHES``, as a
kernel wrapper does.
"""

from __future__ import annotations

import contextlib
import gc
import io
import itertools
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from msda_tpu.models.detr import DeformableDetr as JaxDetr  # noqa: E402
from msda_tpu.models.detr import postprocess as jax_postprocess  # noqa: E402
from msda_tpu_torch.models import DeformableDetr, postprocess, state_dict_from_flax  # noqa: E402
from msda_tpu_torch.ops import cuda_fwd, launches, library  # noqa: E402
from msda_tpu_torch.utils import export_fn, graphed, load_exported  # noqa: E402
from msda_tpu_torch.utils import graphs as graphs_module  # noqa: E402
from utils import DEFAULT_CFG, make_pyramid_shapes  # noqa: E402


class _Graph:
    """A CUDA graph stand-in: the work recorded while it was being captured
    runs again at each replay; ``pool`` is the memory pool it was captured
    in."""

    made = 0
    recording = None  # the graph under capture

    def __init__(self):
        _Graph.made += 1
        self.work = []
        self.pool = None

    def replay(self):
        for work in self.work:
            work()


@pytest.fixture
def stubbed(monkeypatch):
    """The streams, the graph and the pool handles stubbed,
    ``cuda_fwd.LAUNCHES`` at 0."""

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None):
        g.pool = pool
        _Graph.recording = g
        try:
            yield
        finally:
            _Graph.recording = None

    handles = itertools.count()

    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, next(handles)))
    monkeypatch.setattr(_Graph, "made", 0)
    monkeypatch.setattr(cuda_fwd, "LAUNCHES", 0)


@pytest.fixture
def on_a_card(stubbed, monkeypatch):
    """``graphed`` takes the CPU tensors for CUDA ones."""
    monkeypatch.setattr(graphs_module, "_card",
                        lambda tensors: torch.device("cuda", 0))


def scaled(x, k, shift=None):
    """``x * k (+ shift)`` and ``k``: one kernel launch, recorded in the
    graph under capture."""
    cuda_fwd.LAUNCHES += 1
    out = x * k if shift is None else x * k + shift
    g = _Graph.recording
    if g is not None:
        g.work.append(lambda: out.copy_(
            x * k if shift is None else x * k + shift))
    return {"out": out, "k": k}


def _tensor(seed, shape=(2, 3), dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def test_warm_up_then_capture_then_replays(on_a_card):
    """Call 1 runs the function (the warm-up), call 2 captures it on static
    copies of the inputs and replays it, later calls copy their inputs in
    and replay.  The counters keep the warm-up's launch, none for the
    capture, and one a replay."""
    serve = graphed(scaled)
    a, b, c = _tensor(0), _tensor(1), _tensor(2)
    assert torch.equal(serve(a, 3)["out"], a * 3)
    assert (_Graph.made, cuda_fwd.LAUNCHES) == (0, 1)
    first = serve(a, 3)
    assert (_Graph.made, cuda_fwd.LAUNCHES) == (1, 2)
    assert torch.equal(first["out"], a * 3) and first["k"] == 3
    second = serve(b, 3)
    third = serve(c, 3)
    assert (_Graph.made, cuda_fwd.LAUNCHES) == (1, 4)
    assert torch.equal(second["out"], b * 3)
    assert torch.equal(third["out"], c * 3)
    # the outputs are clones: a replay leaves earlier results alone
    assert torch.equal(first["out"], a * 3)
    assert torch.equal(second["out"], b * 3)


@pytest.mark.parametrize("change", ["shape", "dtype", "k", "keyword",
                                    "grad mode"])
def test_a_new_signature_warms_up_and_captures_anew(on_a_card, change):
    """A new shape, dtype, non-tensor leaf (``top_k``, ``scoring``),
    structure or grad mode is a new signature: its first call warms up,
    its second captures a graph of its own; the first signature replays
    its own graph after that."""
    serve = graphed(scaled)
    a = _tensor(0)
    serve(a, 3)
    serve(a, 3)
    args, kwargs, mode = (a, 3), {}, torch.enable_grad()
    if change == "shape":
        args = (_tensor(1, (4, 3)), 3)
    elif change == "dtype":
        args = (a.double(), 3)
    elif change == "k":
        args = (a, 4)
    elif change == "keyword":
        kwargs = {"shift": _tensor(2)}
    else:
        mode = torch.no_grad()
    want = scaled(*args, **kwargs)["out"]
    with mode:
        assert torch.equal(serve(*args, **kwargs)["out"], want)
        assert _Graph.made == 1
        for _ in range(2):
            assert torch.equal(serve(*args, **kwargs)["out"], want)
        assert _Graph.made == 2
    b = _tensor(3)
    assert torch.equal(serve(b, 3)["out"], b * 3)
    assert _Graph.made == 2


def test_static_inputs_follow_the_inference_mode(on_a_card):
    """Static inputs cloned under ``inference_mode`` are inference tensors,
    which ``copy_`` cannot write outside that mode; the mode is part of the
    signature, so a call outside it warms up and captures its own graph."""
    captured = []  # whether each capture's input is an inference tensor

    def record(x):
        if _Graph.recording is not None:
            captured.append(x.is_inference())
        return scaled(x, 3)

    serve = graphed(record)
    a, b = _tensor(0), _tensor(1)
    with torch.inference_mode():
        serve(a)
        serve(a)
    assert captured == [True]
    for _ in range(3):  # a warm-up, a capture, a replay
        assert torch.equal(serve(b)["out"], b * 3)
    assert captured == [True, False] and _Graph.made == 2
    with torch.inference_mode():
        assert torch.equal(serve(b)["out"], b * 3)
    assert _Graph.made == 2


def test_cpu_tensors_run_the_function_itself(stubbed):
    """Off the card every call is the function's own; ``__wrapped__`` is
    the function."""
    serve = graphed(scaled)
    assert serve.__wrapped__ is scaled
    assert serve.__name__ == "graphed_scaled"
    a = _tensor(0)
    for _ in range(3):
        assert torch.equal(serve(a, 3)["out"], a * 3)
    assert (_Graph.made, cuda_fwd.LAUNCHES) == (0, 3)


def test_a_failed_capture_raises(on_a_card):
    """A capture that fails (here as a host sync fails under a capture)
    raises, at every call: nothing falls back to the eager call, and the
    counters keep no launch of the failed capture."""
    def syncs(x):
        cuda_fwd.LAUNCHES += 1
        if _Graph.recording is not None:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x * 2

    serve = graphed(syncs)
    a = _tensor(0)
    assert torch.equal(serve(a), a * 2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            serve(a)
    assert cuda_fwd.LAUNCHES == 1


def test_a_changed_option_captures_again(on_a_card):
    """``options``: what a capture read outside the arguments; a call that
    finds it changed (a tensor by identity, anything else by value)
    captures again."""
    opts = {"lr": 0.1, "state": torch.zeros(2)}
    serve = graphed(scaled, options=lambda: dict(opts))
    a = _tensor(0)
    for _ in range(3):
        serve(a, 3)
    assert _Graph.made == 1
    opts["state"].fill_(1.0)  # in place: what the graph reads
    serve(a, 3)
    assert _Graph.made == 1
    opts["lr"] = 0.2
    serve(a, 3)
    opts["state"] = torch.zeros(2)
    serve(a, 3)
    serve(a, 3)
    assert _Graph.made == 3


def _recorded(statics):
    """``scaled(x, 3)`` that keeps a weak reference to the static input of
    each capture in ``statics``, by the input's shape, and the pool of each
    capture in ``statics["pools"]``."""
    def fn(x):
        if _Graph.recording is not None:
            statics[tuple(x.shape)] = weakref.ref(x)
            statics.setdefault("pools", []).append(_Graph.recording.pool)
        return scaled(x, 3)
    return fn


def test_every_capture_of_a_function_shares_one_pool(on_a_card):
    """Every capture of one graphed function (two signatures here) gets the
    same pool handle; another graphed function gets another."""
    seen, other = {}, {}
    serve, again = graphed(_recorded(seen)), graphed(_recorded(other))
    for shape in ((2, 3), (4, 3)):
        x = _tensor(0, shape)
        for _ in range(3):
            assert torch.equal(serve(x)["out"], x * 3)
    for _ in range(2):
        again(_tensor(1))
    assert _Graph.made == 3
    assert len(seen["pools"]) == 2 and len(set(seen["pools"])) == 1
    assert set(seen["pools"]).isdisjoint(other["pools"])
    assert None not in seen["pools"] + other["pools"]


def test_the_least_recently_called_signature_is_dropped(on_a_card):
    """At ``max_signatures`` a new signature drops the least recently
    called one, warmed up or captured: its static inputs are freed."""
    seen = {}
    serve = graphed(_recorded(seen), max_signatures=2)
    a, b, c = _tensor(0, (2, 3)), _tensor(1, (3, 3)), _tensor(2, (4, 3))
    for x in (a, a, b, b, a):  # a is now the most recently called
        serve(x)
    assert _Graph.made == 2 and serve.cache_size() == 2
    assert torch.equal(serve(c)["out"], c * 3)  # c's warm-up drops b
    assert serve.cache_size() == 2
    gc.collect()
    assert seen[(3, 3)]() is None and seen[(2, 3)]() is not None
    serve(c)  # c's capture
    assert torch.equal(serve(a)["out"], a * 3)  # a's replay, a kept
    assert _Graph.made == 3
    serve(_tensor(3, (5, 3)))  # drops c, the least recently called now
    gc.collect()
    assert seen[(4, 3)]() is None and seen[(2, 3)]() is not None


def test_a_dropped_signature_warms_up_and_captures_again(on_a_card):
    """A signature that returns after it was dropped is new again: a
    warm-up (the function run eagerly), then a capture, in the same pool."""
    seen = {}
    serve = graphed(_recorded(seen), max_signatures=1)
    a, b = _tensor(0, (2, 3)), _tensor(1, (3, 3))
    serve(a)
    serve(a)
    serve(b)  # b's warm-up drops a
    assert (_Graph.made, cuda_fwd.LAUNCHES) == (1, 3)
    assert torch.equal(serve(a)["out"], a * 3)  # a's warm-up: eager
    assert (_Graph.made, cuda_fwd.LAUNCHES) == (1, 4)
    assert torch.equal(serve(a)["out"], a * 3)  # a's capture and replay
    assert torch.equal(serve(a)["out"], a * 3)
    assert _Graph.made == 2 and serve.cache_size() == 1
    assert len(seen["pools"]) == 2 and len(set(seen["pools"])) == 1


def test_interleaved_signatures_replay_their_own_graphs(on_a_card):
    """Three signatures called in turns: once each has its graph, every
    call replays its own signature's graph on its new inputs."""
    serve = graphed(scaled)
    shapes = ((2, 3), (4, 3), (3, 5))
    for seed in range(5):
        for shape in shapes:
            x = _tensor(10 * seed, shape)
            assert torch.equal(serve(x, 3)["out"], x * 3)
    assert _Graph.made == 3 and serve.cache_size() == 3
    assert cuda_fwd.LAUNCHES == 15


def test_a_recapture_keeps_the_pool(on_a_card):
    """A capture again after a changed option is made in the function's
    pool, where the graph it replaces lies."""
    seen = {}
    opts = {"lr": 0.1}
    serve = graphed(_recorded(seen), options=lambda: dict(opts))
    a = _tensor(0)
    serve(a)
    serve(a)
    opts["lr"] = 0.2
    assert torch.equal(serve(a)["out"], a * 3)
    assert _Graph.made == 2 and serve.cache_size() == 1
    assert len(seen["pools"]) == 2 and len(set(seen["pools"])) == 1


def test_max_signatures_is_at_least_one():
    with pytest.raises(ValueError, match="at least 1"):
        graphed(scaled, max_signatures=0)


def test_launch_counters_take_each_replay(on_a_card):
    """Through ``ops.launches``: the capture leaves every counter as it
    was, a replay adds the captured launches."""
    serve = graphed(scaled)
    a = _tensor(0)
    launches.reset()
    serve(a, 3)
    before = launches.counts()
    serve(a, 3)  # the capture and its replay
    serve(a, 3)
    after = launches.counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * (k == cuda_fwd.KERNEL) for k in after}


def test_load_exported_is_the_graphed_program(stubbed):
    """``load_exported`` returns the program graphed; on CPU tensors its
    output is its ``__wrapped__`` program's, and that program's own input
    checks still refuse another shape."""
    shapes = ((8, 8), (4, 4))
    flat = library.flat_shapes(shapes)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((2, 80, 2, 8)).astype(
        np.float32))
    pts = torch.from_numpy(rng.random((2, 10, 2, 2, 3, 2)).astype(
        np.float32))
    wts = torch.softmax(torch.from_numpy(rng.standard_normal(
        (2, 10, 2, 2, 3)).astype(np.float32)), -1)
    blob = export_fn(lambda i, p, w: library.msda_fwd(i, p, w, flat,
                                                      "border", False),
                     img, pts, wts)
    served = load_exported(blob)
    assert served.__name__.startswith("graphed_")
    assert isinstance(served.__wrapped__, torch.fx.GraphModule)
    got = served(img, pts, wts)
    assert torch.equal(got, served.__wrapped__(img, pts, wts))
    assert torch.equal(got, torch.export.load(io.BytesIO(blob)).module()(
        img, pts, wts))
    assert _Graph.made == 0
    with pytest.raises(AssertionError, match="Guard failed"):
        served(img[:1], pts[:1], wts[:1])


# the two-stage detector with box refinement at tests/utils.DEFAULT_CFG's
# geometry (4 heads of 32 channels, 4 levels of base 16, 3 points)
SHAPES = tuple(map(tuple, make_pyramid_shapes(DEFAULT_CFG["L"]).tolist()))
IN_CH = (16, 24, 16, 8)
DETR_KW = dict(num_classes=5, emb_dim=DEFAULT_CFG["H"] * DEFAULT_CFG["C"],
               num_heads=DEFAULT_CFG["H"], num_points=DEFAULT_CFG["P"],
               num_queries=8, num_encoder_layers=2, num_decoder_layers=2,
               ffn_dim=64, with_box_refinement=True, two_stage=True)
IMAGE_SIZES = np.asarray([[128, 120], [96, 128]], np.float32)


@pytest.mark.parametrize("path", ["cpu", "capture"])
def test_graphed_detector_serves_as_jax_jit(cpu_device, stubbed, monkeypatch,
                                            path):
    """``graphed(lambda pyr, sizes: postprocess(model(pyr, shapes), ...))``
    under ``inference_mode``, with ``image_sizes`` a tensor, against the
    JAX model + ``postprocess`` under ``jax.jit`` from the same flax
    parameters: labels equal, scores and boxes within 1e-5.  ``cpu``: the
    function itself runs; ``capture``: a warm-up, a capture and a replay
    through the stubbed graph (the capture's outputs come back cloned)."""
    B = DEFAULT_CFG["B"]
    rng = np.random.default_rng(4)
    pyramid = [rng.standard_normal((B, h, w, c)).astype(np.float32)
               for (h, w), c in zip(SHAPES, IN_CH)]
    jmodel = JaxDetr(**DETR_KW, impl="reference")
    jshapes = np.asarray(SHAPES, np.int32)

    def jserve(params, pyr, sizes):
        return jax_postprocess(jmodel.apply(params, pyr, jshapes), top_k=10,
                               scoring="sigmoid", image_sizes=sizes)

    with jax.default_device(cpu_device):
        params = jmodel.init(jax.random.PRNGKey(0),
                             [jnp.asarray(p) for p in pyramid], jshapes)
        want = jax.tree.map(np.asarray, jax.jit(jserve)(
            params, pyramid, IMAGE_SIZES))

    model = DeformableDetr(**DETR_KW, in_channels=IN_CH, impl="reference")
    model.load_state_dict(state_dict_from_flax(params))
    model.eval()
    serve = graphed(lambda pyr, sizes: postprocess(
        model(pyr, SHAPES), top_k=10, scoring="sigmoid", image_sizes=sizes))
    if path == "capture":
        monkeypatch.setattr(graphs_module, "_card",
                            lambda tensors: torch.device("cuda", 0))
    tensors = [torch.from_numpy(p) for p in pyramid]
    sizes = torch.from_numpy(IMAGE_SIZES)
    with torch.inference_mode():
        calls = [serve(tensors, sizes) for _ in range(3)]
        # a host list of sizes decodes the same boxes as the tensor
        listed = postprocess(model(tensors, SHAPES), top_k=10,
                             scoring="sigmoid",
                             image_sizes=IMAGE_SIZES.tolist())
    assert _Graph.made == (1 if path == "capture" else 0)
    assert torch.equal(listed["boxes"], calls[0]["boxes"])
    for got in calls:
        got = {k: v.numpy() for k, v in got.items()}
        assert got["scores"].shape == (B, 10)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for k in ("scores", "boxes"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
