"""The port's auction matcher and the graphed train step's CPU side,
against the JAX package on the CPU.

On a CUDA cost ``auction_assignment`` launches the hand-written kernel
(``csrc/msda_auction.cu``, tested on the card by
``tests/test_torch_kernels.py``); on a CPU cost it runs the plain version,
``matcher.plain_auction``, which is held here to the JAX solver (vmapped,
as the JAX train step runs it) index for index, ``converged`` included:
tie-heavy quantised costs, masks, square problems, round budgets that
leave it unconverged.  The same seeded f32 costs go to both
(``tests/conftest.py`` turns x64 on, so the JAX side gets explicit f32
arrays).

``make_train_step`` captures the step as a CUDA graph only for parameters
on a card; here it stays eager, and its capturable-optimizer check is
reached with the parameters' device and ``torch.cuda.is_available``
stubbed (a CPU build holds no CUDA tensor).  With the streams and the graph
stubbed too, the graphed step's bookkeeping runs here: when it captures,
when it captures again (an optimizer option changed) and when it replays.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from msda_tpu.parallel import matcher as jax_matcher  # noqa: E402
from msda_tpu_torch.models import DeformableDetr, init_parameters  # noqa: E402
from msda_tpu_torch.ops import cuda_bwd, cuda_fwd, cuda_stream, launches  # noqa: E402
from msda_tpu_torch.parallel import (  # noqa: E402
    auction_assignment,
    cuda_auction_large,
    cuda_matcher,
    make_train_step,
)
from msda_tpu_torch.parallel import train as train_module  # noqa: E402
from msda_tpu_torch.parallel.matcher import plain_auction  # noqa: E402
from msda_tpu_torch.utils import graphs as graphs_module  # noqa: E402

F32 = np.float32
EPS = 1e-3  # the matcher's default bid increment


def _costs(kind, shape, seed):
    """Seeded ``(cost [B, N, M] f32, mask [B, M] f32 or None)``."""
    rng = np.random.default_rng(seed)
    B, _, M = shape
    uniform = rng.random(shape, dtype=F32)
    if kind == "uniform":
        return uniform, None
    if kind == "ties":  # four cost values: ties in every argmax
        return np.floor(uniform * 4).astype(F32), None
    if kind == "constant":
        return np.full(shape, 0.5, F32), None
    if kind == "masked":  # a few real slots, the rest cost 0 (detection_loss)
        mask = np.zeros((B, M), F32)
        for b in range(B):
            mask[b, :rng.integers(2, M // 2)] = 1.0
        return np.where(mask[:, None, :] > 0, uniform, 0).astype(F32), mask
    raise ValueError(kind)


def _jax_auction(cost, mask, max_rounds):
    """The JAX solver vmapped over the batch, as its train step runs it."""
    mask = np.ones(cost.shape[::2], F32) if mask is None else mask
    fn = jax.jit(jax.vmap(lambda c, m: jax_matcher.auction_assignment(
        c, m, eps=EPS, max_rounds=max_rounds, return_state=True)))
    out, conv = fn(jnp.asarray(cost), jnp.asarray(mask))
    return np.asarray(out), np.asarray(conv)


def _torch_auction(cost, mask, max_rounds):
    got, conv = auction_assignment(
        torch.from_numpy(cost),
        None if mask is None else torch.from_numpy(mask), eps=EPS,
        max_rounds=max_rounds, return_state=True)
    return got.numpy(), conv.numpy()


@pytest.mark.parametrize("kind,shape", [
    ("uniform", (3, 40, 12)),
    ("ties", (3, 40, 12)),
    ("ties", (2, 24, 24)),       # square and tied
    ("constant", (2, 16, 16)),   # every bid a tie: one target a round
    ("masked", (3, 40, 12)),
    ("uniform", (2, 32, 32)),    # square: the most rounds
])
def test_plain_auction_matches_jax(kind, shape):
    cost, mask = _costs(kind, shape, seed=len(kind) + shape[1])
    want, want_conv = _jax_auction(cost, mask, 2000)
    got, conv = _torch_auction(cost, mask, 2000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(conv, want_conv)
    assert conv.all()


@pytest.mark.parametrize("max_rounds", [1, 3, 17])
def test_plain_auction_round_budgets_match_jax(max_rounds):
    """Budgets that end the square problem unconverged: the argmin fallback
    and the flags, index for index."""
    cost, _ = _costs("uniform", (2, 48, 48), seed=7)
    want, want_conv = _jax_auction(cost, None, max_rounds)
    got, conv = _torch_auction(cost, None, max_rounds)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(conv, want_conv)
    assert not conv.any()


def test_cpu_cost_runs_the_plain_version(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU cost must not reach the kernel")

    monkeypatch.setattr(cuda_matcher, "auction", no_kernel)
    monkeypatch.setattr(cuda_matcher, "LAUNCHES", 0)
    cost, mask = _costs("masked", (2, 20, 8), seed=3)
    got, conv = auction_assignment(torch.from_numpy(cost),
                                   torch.from_numpy(mask),
                                   return_state=True)
    want, want_conv = plain_auction(torch.from_numpy(cost),
                                    torch.from_numpy(mask) > 0, EPS, 2000)
    assert torch.equal(got, want) and torch.equal(conv, want_conv)
    assert cuda_matcher.LAUNCHES == 0


def test_kernel_wrapper_refuses_cpu_costs():
    """The wrapper launches or raises: no fallback to the plain version."""
    before = cuda_matcher.LAUNCHES
    with pytest.raises(ValueError, match="CUDA cost"):
        cuda_matcher.auction(torch.zeros(1, 4, 2))
    assert cuda_matcher.LAUNCHES == before


# --------------------------------------------------------------------------
# the train step

SHAPES = ((8, 8), (4, 4))
MODEL_KW = dict(num_classes=5, in_channels=(8, 8), emb_dim=32, num_heads=4,
                num_points=2, num_queries=12, num_encoder_layers=1,
                num_decoder_layers=2, ffn_dim=32, with_box_refinement=True)
LOSS_KW = dict(matcher="auction", class_loss="focal", return_metrics=True)


def _model():
    return init_parameters(DeformableDetr(**MODEL_KW),
                           torch.Generator().manual_seed(0)).train()


def _batch():
    rng = np.random.default_rng(1)
    pyramid = [torch.from_numpy(rng.standard_normal((2, h, w, 8), dtype=F32))
               for h, w in SHAPES]
    mask = np.zeros((2, 4), F32)
    mask[0, :3] = mask[1, :1] = 1.0
    targets = {
        "labels": torch.from_numpy(rng.integers(0, 5, (2, 4))),
        "boxes": torch.from_numpy(np.concatenate(
            [rng.uniform(0.2, 0.8, (2, 4, 2)),
             rng.uniform(0.05, 0.5, (2, 4, 2))], -1).astype(F32)),
        "mask": torch.from_numpy(mask),
    }
    return pyramid, targets


def test_cpu_step_is_eager_and_wraps_the_eager_step():
    """On the CPU the step is the eager step; ``__wrapped__`` reaches it as
    on a card: both give the same losses and parameters."""
    pyramid, targets = _batch()
    models = [_model(), _model()]
    steps = [make_train_step(m, torch.optim.SGD(m.parameters(), lr=1e-2),
                             SHAPES, **LOSS_KW) for m in models]
    assert all(callable(s.__wrapped__) for s in steps)
    for _ in range(2):
        (loss, metrics), (wloss, _) = (steps[0](pyramid, targets),
                                       steps[1].__wrapped__(pyramid, targets))
        assert torch.equal(loss, wloss) and torch.isfinite(loss)
        assert bool(metrics["matcher_converged"])
    for p, q in zip(*(m.parameters() for m in models)):
        assert torch.equal(p, q)


@pytest.fixture
def on_a_card(monkeypatch):
    """Make ``make_train_step`` take the model's parameters for CUDA ones."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(train_module, "_param_device",
                        lambda model: torch.device("cuda", 0))


def test_graphed_step_needs_a_capturable_optimizer(on_a_card):
    model = _model()
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_step(model, torch.optim.AdamW(model.parameters()),
                        SHAPES, **LOSS_KW)


@pytest.mark.parametrize("optimizer", ["adagrad", "adamw_one_group",
                                       "sgd_subclass"])
def test_graphed_step_refuses_host_state(on_a_card, optimizer):
    """Only groups that set capturable=True, or SGD itself, are taken:
    Adagrad has no such option (its step count lies on the host), a second
    group without it is refused as the first would be, and a subclass of
    SGD may keep state anywhere."""
    model = _model()
    params = list(model.parameters())
    if optimizer == "adagrad":
        opt = torch.optim.Adagrad(params)
    elif optimizer == "adamw_one_group":
        opt = torch.optim.AdamW([{"params": params[:2], "capturable": True},
                                 {"params": params[2:]}])
    else:
        opt = type("MySGD", (torch.optim.SGD,), {})(params, lr=1e-2)
    with pytest.raises(ValueError, match="capturable=True"):
        make_train_step(model, opt, SHAPES, **LOSS_KW)


@pytest.mark.parametrize("optimizer", ["adamw_capturable", "sgd"])
def test_graphed_step_takes_capturable_optimizers(on_a_card, optimizer):
    """AdamW(capturable=True), and SGD, which has no such option and keeps
    no state on the host; nothing runs before the first call."""
    model = _model()
    opt = (torch.optim.AdamW(model.parameters(), capturable=True)
           if optimizer == "adamw_capturable"
           else torch.optim.SGD(model.parameters(), lr=1e-2))
    step = make_train_step(model, opt, SHAPES, **LOSS_KW)
    assert step.__name__ == "graphed_step" and callable(step.__wrapped__)


def test_launch_counts_take_the_replays_counts(monkeypatch):
    """A replay adds the captured step's launches to every wrapper's
    counter, through the one registry (``ops.launches``)."""
    counts = launches.counts()
    assert set(counts) == {"msda_fwd", "msda_bwd", "msda_auction",
                           "msda_auction_large", "msda_stream_bin",
                           "msda_stream_fwd", "msda_stream_bwd", "msda_norm",
                           "msda_fwd_queries"}
    monkeypatch.setattr(cuda_fwd, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_bwd, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_matcher, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_auction_large, "LAUNCHES", 0)
    monkeypatch.setattr(cuda_stream, "LAUNCHES",
                        dict.fromkeys(cuda_stream.KERNELS, 0))
    step = dict.fromkeys(counts, 0)
    step.update(msda_fwd=12, msda_bwd=12, msda_auction=6)
    for _ in range(3):
        launches.add(step)
    assert launches.counts() == {k: 3 * v for k, v in step.items()}
    assert (cuda_fwd.LAUNCHES, cuda_bwd.LAUNCHES, cuda_matcher.LAUNCHES) == (
        36, 36, 18)
    launches.reset()
    assert set(launches.counts().values()) == {0}


class _FakeGraph:
    """A CUDA graph that records its capture and counts its replays."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@pytest.fixture
def graphs_stubbed(on_a_card, monkeypatch):
    """The streams and the graph of ``utils.graphs.graphed`` stubbed, and
    its inputs taken for CUDA ones: the warm-up and the capture run the
    step on the CPU, a replay runs nothing.  Yields the list of
    captures."""
    captured = []

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None):
        captured.append(g)
        yield

    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(_FakeGraph, "replays", 0)
    monkeypatch.setattr(graphs_module, "_card",
                        lambda tensors: torch.device("cuda", 0))
    yield captured


def test_graphed_step_captures_again_when_an_option_changes(graphs_stubbed):
    """Call 1 warms up, call 2 captures and replays, later calls replay; a
    float lr changed by hand or by a scheduler, a new option (the
    scheduler's ``initial_lr``), the optimizer's state loaded anew or
    another parameter list makes the next call capture again, since a
    capture bakes them in."""
    captured = graphs_stubbed
    model = _model()
    sgd = torch.optim.SGD(model.parameters(), lr=1e-2, momentum=0.9)
    step = make_train_step(model, sgd, SHAPES, **LOSS_KW)
    pyramid, targets = _batch()

    def call():
        loss, metrics = step(pyramid, targets)
        assert torch.isfinite(loss)
        return len(captured), _FakeGraph.replays

    assert call() == (0, 0)  # the warm-up
    assert call() == (1, 1)  # the capture and its replay
    assert call() == (1, 2)
    sgd.param_groups[0]["lr"] = 5e-3
    assert call() == (2, 3)
    assert call() == (2, 4)
    schedule = torch.optim.lr_scheduler.StepLR(sgd, step_size=1, gamma=0.5)
    assert call() == (3, 5)  # the group gained initial_lr
    schedule.step()
    assert sgd.param_groups[0]["lr"] == pytest.approx(2.5e-3)
    assert call() == (4, 6)
    sgd.load_state_dict(copy.deepcopy(sgd.state_dict()))  # new buffers
    assert call() == (5, 7)
    sgd.param_groups[0]["params"] = sgd.param_groups[0]["params"][1:]
    assert call() == (6, 8)
    assert call() == (6, 9)


def test_options_compare_tensors_by_identity():
    """A tensor option changed in place is what the graph reads (no new
    capture); a new tensor, or a changed value of any other type, is a
    change."""
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=torch.tensor(1e-2))
    captured = train_module._options(opt)
    assert graphs_module._same(captured, train_module._options(opt))
    opt.param_groups[0]["lr"].fill_(5e-3)
    assert graphs_module._same(captured, train_module._options(opt))
    opt.param_groups[0]["lr"] = torch.tensor(5e-3)
    assert not graphs_module._same(captured, train_module._options(opt))
    captured = train_module._options(opt)
    opt.param_groups[0]["momentum"] = 0.9
    assert not graphs_module._same(captured, train_module._options(opt))
    captured = train_module._options(opt)
    opt.param_groups[0]["momentum"] = 1  # an int is not the float 0.9
    assert not graphs_module._same(captured, train_module._options(opt))
