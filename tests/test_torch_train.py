"""The port's training recipe (msda_tpu_torch.parallel, the model's remat
and the demo) against the JAX package on the CPU.

The same seeded numpy inputs go through both packages, the JAX side in f32
(``tests/conftest.py`` turns x64 on, so every JAX input is an explicit f32
array).  Tolerances:
  * box geometry 1e-6 (the same f32 formulas);
  * matcher: assignments and ``converged`` flags equal, index for index, on
    the same cost matrix; ``matching_cost`` 1e-6;
  * detection loss and its gradients 1e-5 (f32 sums in different orders);
  * the train step's gradients 1e-4 of each tensor's largest gradient (a
    deep f32 model, as in test_torch_models.py), that scale being at least
    1e-3 of the model's largest gradient: a gradient that is zero in exact
    arithmetic (the self-attention key bias, to which the softmax is
    invariant) holds rounding noise only.  Parameters after two SGD steps
    1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from msda_tpu.models import detr as jax_detr  # noqa: E402
from msda_tpu.parallel import boxes as jax_boxes  # noqa: E402
from msda_tpu.parallel import matcher as jax_matcher  # noqa: E402
from msda_tpu.parallel import train as jax_train  # noqa: E402
from msda_tpu_torch import train_demo  # noqa: E402
from msda_tpu_torch.models import DeformableDetr, state_dict_from_flax  # noqa: E402
from msda_tpu_torch.parallel import (  # noqa: E402
    TrainCheckpointer,
    auction_assignment,
    boxes,
    detection_loss,
    make_train_step,
    matching_cost,
)
from utils import make_pyramid_shapes  # noqa: E402

F32 = np.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy()


# --------------------------------------------------------------------------
# boxes


def _box_pairs(seed, degenerate):
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.uniform(0.2, 0.8, (2, 6, 2)),
                        rng.uniform(0.05, 0.5, (2, 6, 2))], -1).astype(F32)
    b = np.concatenate([rng.uniform(0.2, 0.8, (2, 6, 2)),
                        rng.uniform(0.05, 0.5, (2, 6, 2))], -1).astype(F32)
    if degenerate:
        a[0, 0, 2:] = 0.0        # a point
        a[0, 1, 2] = 0.0         # a vertical segment
        b[0, 1] = a[0, 1]        # ... matched with itself
        a[1, 2] = 0.0            # all zeros, like a padded target
        b[1, 2] = 0.0
        b[1, 3] = a[1, 3]        # identical boxes
        b[0, 4, :2] = 5.0        # far apart
    return a, b


_BOX_FUNCS = ["box_cxcywh_to_xyxy", "box_iou_pairwise",
              "generalized_box_iou_pairwise", "generalized_box_iou"]


@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("name", _BOX_FUNCS)
def test_box_function_and_gradients_match_jax(name, degenerate):
    a, b = _box_pairs(3, degenerate)
    jfn, tfn = getattr(jax_boxes, name), getattr(boxes, name)
    args = (a,) if name == "box_cxcywh_to_xyxy" else (a, b)
    want = np.asarray(jfn(*args))
    cot = np.random.default_rng(4).standard_normal(want.shape).astype(F32)
    jgrads = jax.grad(lambda *xs: (jfn(*xs) * cot).sum(),
                      argnums=tuple(range(len(args))))(*args)

    targs = [_t(x).requires_grad_(True) for x in args]
    got = tfn(*targs)
    (got * _t(cot)).sum().backward()
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    for tx, jg in zip(targs, jgrads):
        jg = np.asarray(jg)
        assert np.isfinite(jg).all()
        np.testing.assert_allclose(_np(tx.grad), jg, rtol=1e-6,
                                   atol=1e-6 * max(1.0, np.abs(jg).max()))


# --------------------------------------------------------------------------
# matcher


def _check_auction(cost, mask=None, **kw):
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_conv = auction_assignment_jax(cost, jmask, **kw)
    got, conv = auction_assignment(
        _t(cost), None if mask is None else _t(mask), return_state=True,
        **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(conv) == want_conv
    return got.numpy(), bool(conv)


def auction_assignment_jax(cost, mask, **kw):
    out, conv = jax_matcher.auction_assignment(
        jnp.asarray(cost), mask, return_state=True, **kw)
    return np.asarray(out), bool(conv)


@pytest.mark.parametrize("n,m,seed", [(20, 8, 0), (50, 50, 1), (300, 30, 2)])
def test_auction_matches_jax(n, m, seed):
    cost = np.random.default_rng(seed).random((n, m)).astype(F32)
    got, conv = _check_auction(cost, eps=1e-5)
    assert conv and len(set(got.tolist())) == m


def test_auction_with_mask_matches_jax():
    cost = np.random.default_rng(3).random((10, 6)).astype(F32)
    mask = np.asarray([1, 1, 0, 1, 0, 1], F32)
    _check_auction(cost, mask, eps=1e-5)


@pytest.mark.parametrize("n,m,seed", [(40, 40, 0), (64, 48, 1)])
def test_auction_near_ties_match_jax(n, m, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n, m)).astype(F32)  # heavy ties
    cost = base + rng.random((n, m)).astype(F32) * 1e-6
    _, conv = _check_auction(cost, eps=1e-5)
    assert conv


def test_auction_constant_cost_matches_jax():
    got, conv = _check_auction(np.ones((12, 12), F32), eps=1e-4)
    assert conv and len(set(got.tolist())) == 12


@pytest.mark.parametrize("max_rounds", [1, 5, 17, 40])
def test_auction_round_budget_matches_jax(max_rounds):
    """Non-convergence under a small budget, with the argmin fallback; 17
    and 40 rounds end inside the second and third chunks of convergence
    tests."""
    cost = np.random.default_rng(1).random((50, 50)).astype(F32)
    _, conv = _check_auction(cost, eps=1e-5, max_rounds=max_rounds)
    assert not conv


def test_batched_auction_matches_vmap():
    rng = np.random.default_rng(4)
    costs = rng.random((3, 16, 5)).astype(F32)
    masks = (rng.random((3, 5)) < 0.7).astype(F32)
    masks[:, 0] = 1.0
    fn = jax.jit(jax.vmap(lambda c, mk: jax_matcher.auction_assignment(
        c, mk, eps=1e-4, return_state=True)))
    want, want_conv = (np.asarray(x) for x in fn(jnp.asarray(costs),
                                                 jnp.asarray(masks)))
    got, conv = auction_assignment(_t(costs), _t(masks), eps=1e-4,
                                   return_state=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(conv.numpy(), want_conv)


@pytest.mark.parametrize("class_cost", ["softmax", "focal"])
def test_matching_cost_matches_jax(class_cost):
    rng = np.random.default_rng(5)
    B, N, M, K = 2, 12, 5, 7
    logits = (rng.standard_normal((B, N, K)) * 3).astype(F32)
    bx = rng.uniform(0.1, 0.9, (B, N, 4)).astype(F32)
    tb = rng.uniform(0.1, 0.9, (B, M, 4)).astype(F32)
    bx[0, 0, 2:] = 0.0  # a degenerate prediction
    labels = rng.integers(0, K, (B, M)).astype(np.int32)
    want = np.asarray(jax.vmap(lambda *a: jax_matcher.matching_cost(
        *a, class_cost=class_cost))(logits, bx, labels, tb))
    got = matching_cost(_t(logits), _t(bx), _t(labels), _t(tb),
                        class_cost=class_cost)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    single = matching_cost(_t(logits[1]), _t(bx[1]), _t(labels[1]),
                           _t(tb[1]), class_cost=class_cost)
    np.testing.assert_allclose(_np(single), want[1], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="class_cost"):
        matching_cost(_t(logits), _t(bx), _t(labels), _t(tb),
                      class_cost="hinge")


# --------------------------------------------------------------------------
# detection loss


def _loss_inputs(seed=0, B=2, N=12, K=6, M=5, I=40, aux=2):  # noqa: E741
    rng = np.random.default_rng(seed)

    def head():
        return {"logits": rng.standard_normal((B, N, K)).astype(F32),
                "boxes": rng.uniform(0.05, 0.95, (B, N, 4)).astype(F32)}

    outputs = head()
    outputs["aux"] = [head() for _ in range(aux)]
    outputs["enc"] = {
        "logits": rng.standard_normal((B, I, 1)).astype(F32),
        "boxes": rng.uniform(0.05, 0.95, (B, I, 4)).astype(F32),
        "anchors": rng.uniform(0.05, 0.95, (I, 4)).astype(F32),
    }
    mask = (rng.random((B, M)) < 0.7).astype(F32)
    mask[:, 0] = 1.0
    mask[1, -1] = 0.0
    targets = {
        "labels": rng.integers(0, K - 1, (B, M)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)),
                                 rng.uniform(0.05, 0.5, (B, M, 2))],
                                -1).astype(F32),
        "mask": mask,
    }
    return outputs, targets


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree, path="out"):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("matcher", ["fixed", "auction"])
@pytest.mark.parametrize("class_loss", ["ce", "focal"])
def test_detection_loss_and_gradients_match_jax(class_loss, matcher):
    outputs, targets = _loss_inputs()
    kw = dict(matcher=matcher, class_loss=class_loss, return_metrics=True)
    diff = {k: v for k, v in outputs.items()}
    anchors = diff["enc"].pop("anchors")

    def jloss(o):
        o = dict(o, enc=dict(o["enc"], anchors=anchors))
        return jax_train.detection_loss(o, targets, **kw)

    (want, metrics), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(diff)

    leaves = _tree(lambda a: _t(a).requires_grad_(True), diff)
    tout = dict(leaves, enc=dict(leaves["enc"], anchors=_t(anchors)))
    got, tmetrics = detection_loss(tout, _tree(_t, targets), **kw)
    got.backward()
    assert bool(tmetrics["matcher_converged"]) == bool(
        metrics["matcher_converged"])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    for (path, t), (_, g) in zip(_leaves(leaves), _leaves(jgrads)):
        np.testing.assert_allclose(_np(t.grad), np.asarray(g), rtol=1e-5,
                                   atol=1e-5, err_msg=path)


def test_detection_loss_surfaces_matcher_nonconvergence():
    """One round cannot match 12 real targets to 12 queries; the default
    budget can.  The flags agree with the JAX package's."""
    outputs, targets = _loss_inputs(seed=1, N=12, M=12, aux=0)
    targets["mask"][:] = 1.0
    tout, tt = _tree(_t, outputs), _tree(_t, targets)
    for rounds, want in ((1, False), (2000, True)):
        _, jm = jax_train.detection_loss(outputs, targets, matcher="auction",
                                         matcher_rounds=rounds,
                                         return_metrics=True)
        _, metrics = detection_loss(tout, tt, matcher="auction",
                                    matcher_rounds=rounds,
                                    return_metrics=True)
        assert bool(metrics["matcher_converged"]) == bool(
            jm["matcher_converged"]) == want
    assert detection_loss(tout, tt).ndim == 0
    with pytest.raises(ValueError, match="class_loss"):
        detection_loss(tout, tt, class_loss="hinge")
    with pytest.raises(ValueError, match="matcher"):
        detection_loss(tout, tt, matcher="greedy")


# --------------------------------------------------------------------------
# the train step, against jax.value_and_grad through the JAX model

SHAPES = make_pyramid_shapes(4, 16)
IN_CH = (32, 48, 32, 16)
MODEL_KW = dict(num_classes=8, emb_dim=64, num_heads=4, num_points=2,
                num_queries=16, num_encoder_layers=2, num_decoder_layers=2,
                ffn_dim=128, with_box_refinement=True, two_stage=True)
LOSS_KW = dict(matcher="auction", class_loss="focal")
LR = 1e-2


def _train_data():
    rng = np.random.default_rng(0)
    pyramid = [rng.standard_normal((2, h, w, c)).astype(F32)
               for (h, w), c in zip(SHAPES, IN_CH)]
    mask = np.zeros((2, 6), F32)
    mask[0, :4] = 1.0
    mask[1, :2] = 1.0
    targets = {
        "labels": rng.integers(0, 8, (2, 6)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, 6, 2)),
                                 rng.uniform(0.05, 0.5, (2, 6, 2))],
                                -1).astype(F32),
        "mask": mask,
    }
    return pyramid, targets


@pytest.fixture(scope="module")
def jax_training():
    """Initial params, the first loss and gradients, and the params after
    two SGD steps, from the JAX package."""
    pyramid, targets = _train_data()
    model = jax_detr.DeformableDetr(**MODEL_KW, impl="reference")
    jpyr = [jnp.asarray(p) for p in pyramid]
    params = model.init(jax.random.PRNGKey(4), jpyr, SHAPES)

    def loss_fn(p):
        return jax_train.detection_loss(model.apply(p, jpyr, SHAPES),
                                        targets, **LOSS_KW)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    tx = optax.sgd(LR)
    loss0, grads0 = value_and_grad(params)
    p, state = params, tx.init(params)
    for _ in range(2):
        _, g = value_and_grad(p)
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    return dict(pyramid=pyramid, targets=targets, params=params,
                loss0=float(loss0), grads0=grads0, params2=p)


def _torch_model(params, **kw):
    model = DeformableDetr(**MODEL_KW, in_channels=IN_CH, **kw)
    model.load_state_dict(state_dict_from_flax(params))
    return model


def _torch_batch(data):
    return [_t(p) for p in data["pyramid"]], _tree(_t, data["targets"])


def test_loss_and_gradients_match_jax(jax_training):
    model = _torch_model(jax_training["params"])
    pyramid, targets = _torch_batch(jax_training)
    loss = detection_loss(model(pyramid, SHAPES), targets, **LOSS_KW)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_training["loss0"], rtol=1e-5)
    want = state_dict_from_flax(jax_training["grads0"])
    assert set(want) == {n for n, _ in model.named_parameters()}
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    for name, p in model.named_parameters():
        w = want[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(w.abs().max().item(), floor)
        err = (g - w).abs().max().item() / scale
        assert err <= 1e-4, f"{name}: {err:.2e} of {scale:.2e}"


def test_two_sgd_steps_match_optax(jax_training):
    model = _torch_model(jax_training["params"])
    pyramid, targets = _torch_batch(jax_training)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR),
                           SHAPES, **LOSS_KW)
    losses = [step(pyramid, targets) for _ in range(2)]
    assert losses[0].item() == pytest.approx(jax_training["loss0"],
                                             rel=1e-5)
    want = state_dict_from_flax(jax_training["params2"])
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(_np(p), _np(want[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_train_step_returns_metrics_on_the_device(jax_training):
    model = _torch_model(jax_training["params"])
    pyramid, targets = _torch_batch(jax_training)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_train_step(model, opt, SHAPES, return_metrics=True,
                           **LOSS_KW)
    loss, metrics = step(pyramid, targets)
    assert not loss.requires_grad and loss.ndim == 0
    assert isinstance(metrics["matcher_converged"], torch.Tensor)
    assert bool(metrics["matcher_converged"])


def test_remat_gives_the_same_loss_and_gradients(jax_training):
    pyramid, targets = _torch_batch(jax_training)
    results = []
    for remat in (False, True):
        model = _torch_model(jax_training["params"], remat=remat)
        loss = detection_loss(model(pyramid, SHAPES), targets, **LOSS_KW)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in
                                      model.named_parameters()
                                      if p.grad is not None}))
        with torch.no_grad():  # remat is a no-op without gradients
            model(pyramid, SHAPES)
    (l0, g0), (l1, g1) = results
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert set(g0) == set(g1)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-7,
                                   msg=name)


# --------------------------------------------------------------------------
# checkpoints and the demo


def _tiny_trainer(seed):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 4)).astype(F32))

    def step():
        opt.zero_grad()
        loss = model(x).square().mean()
        loss.backward()
        opt.step()
        return loss.item()

    return model, opt, step


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    model, opt, step = _tiny_trainer(0)
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    for s in (1, 3, 2):
        step()
        ckpt.save(s, model, opt)
    ckpt.save(3, model, opt)  # replacing a step keeps one checkpoint
    assert ckpt.steps() == [1, 2, 3]
    want = {k: v.clone() for k, v in model.state_dict().items()}
    other, other_opt, _ = _tiny_trainer(1)
    assert ckpt.restore(other, other_opt) == 3
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k])
    assert other_opt.state_dict()["state"][0]["step"] == 3
    assert ckpt.restore(other, other_opt, step=1) == 1


def test_checkpoint_resume_continues_the_run(tmp_path):
    model, opt, step = _tiny_trainer(0)
    ckpt = TrainCheckpointer(tmp_path)
    step()
    ckpt.save(1, model, opt)
    uninterrupted = step()
    other, other_opt, other_step = _tiny_trainer(1)
    ckpt.restore(other, other_opt)
    assert other_step() == uninterrupted


def test_checkpoint_missing(tmp_path):
    model, opt, _ = _tiny_trainer(0)
    ckpt = TrainCheckpointer(tmp_path / "new")
    assert ckpt.steps() == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(model, opt)
    ckpt.save(5, model, opt)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(model, opt, step=4)


def test_train_demo_runs_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--batch", "2",
            "--class-loss", "focal"]
    first = train_demo.main(argv + ["--steps", "2", "--ckpt-every", "1"])
    assert len(first) == 2 and all(np.isfinite(first))
    assert TrainCheckpointer(tmp_path).steps() == [1, 2]
    again = train_demo.main(argv + ["--steps", "1"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert len(again) == 1 and np.isfinite(again[0])


def test_train_demo_takes_the_device_as_given(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        train_demo.main(["--ckpt-dir", str(tmp_path), "--steps", "1"])
