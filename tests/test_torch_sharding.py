"""The port's device mesh (``msda_tpu_torch.parallel.sharding``, the mesh
paths of the attention module, the model and the train step, and
``python -m msda_tpu_torch.dryrun``) against the JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's ranks run as 8 gloo processes (``tests/mesh_ranks.py``, through
``msda_tpu_torch.dryrun.run_ranks``), with arrays going both ways through
the test's directory.  One spawn a fixture, shared by its tests.
Tolerances: f64 1e-8; f32 outputs and losses 1e-5; f32 gradients and
parameters 1e-4.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import mesh_ranks  # noqa: E402
from msda_tpu.models.detr import DeformableDetr as JaxDetr  # noqa: E402
from msda_tpu.ops import multiscale_deformable_attention as jax_msda  # noqa: E402
from msda_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from msda_tpu.parallel import make_train_step as jax_make_train_step  # noqa: E402
from msda_tpu.parallel import replicate_params as jax_replicate  # noqa: E402
from msda_tpu.parallel import shard_map_multiscale_deformable_attention as jax_shard_map  # noqa: E402
from msda_tpu.parallel import shard_msda_args as jax_shard_args  # noqa: E402
from msda_tpu.parallel.train import _tp_spec_for as jax_tp_spec_for  # noqa: E402
from msda_tpu_torch.dryrun import run_ranks  # noqa: E402
from msda_tpu_torch.models import state_dict_from_flax  # noqa: E402
from msda_tpu_torch.parallel import make_mesh  # noqa: E402
from msda_tpu_torch.parallel.train import _tp_spec_for  # noqa: E402
from utils import get_functional_data  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = 8
TIMEOUT = 300.0


@pytest.fixture(scope="module")
def jax_mesh(cpu_devices):
    return jax_make_mesh({"dp": 2, "sp": 2, "tp": 2}, cpu_devices)


# --------------------------------------------------------------------------
# the op


@pytest.fixture(scope="module")
def op_run(tmp_path_factory, jax_mesh):
    """The port's op under the (2, 2, 2) mesh (one spawn), and JAX's
    shard_map op on its mesh and single-device op with their gradients,
    on the inputs of tests/test_sharding.py."""
    d = tmp_path_factory.mktemp("op")
    img, shapes, pts, wts, og = get_functional_data(B=2, H=4, N=64, oob=True)
    np.savez(d / "op_inputs.npz", img=img, shapes=shapes, pts=pts, wts=wts,
             og=og)
    run_ranks(mesh_ranks.op, RANKS, str(d), timeout=TIMEOUT)
    got = dict(np.load(d / "op_results.npz"))
    blocks = [json.loads((d / f"blocks_{r}.json").read_text())
              for r in range(RANKS)]

    want = {}
    for dt in (np.float32, np.float64):
        args = [jnp.asarray(a.astype(dt)) for a in (img, pts, wts, og)]
        tag = np.dtype(dt).name

        def loss(i, p, w):
            return jnp.sum(jax_msda(i, shapes, p, w, "border", False,
                                    impl="reference") * args[3])

        want[f"out_{tag}"] = np.asarray(jax_msda(
            args[0], shapes, args[1], args[2], "border", False,
            impl="reference"))
        grads = jax.grad(loss, argnums=(0, 1, 2))(*args[:3])
        for name, g in zip(("img", "pts", "wts"), grads):
            want[f"{name}_grad_{tag}"] = np.asarray(g)
        i_s, _, p_s, w_s = jax_shard_args(jax_mesh, args[0],
                                          jnp.asarray(shapes), args[1],
                                          args[2])
        want[f"shard_map_{tag}"] = np.asarray(jax.jit(
            lambda i, p, w: jax_shard_map(jax_mesh, i, shapes, p, w,
                                          "border", False,
                                          impl="reference"))(i_s, p_s, w_s))
    return got, want, blocks


TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "float64": dict(rtol=1e-8, atol=1e-8)}
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "float64": dict(rtol=1e-8, atol=1e-8)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shard_map_op_matches_jax(op_run, dtype):
    """The port's shard_map op on the (2, 2, 2) gloo mesh against JAX's
    shard_map op on its (2, 2, 2) CPU mesh and the single-device op."""
    got, want, _ = op_run
    out = got[f"out_{dtype}"]
    assert out.dtype == np.dtype(dtype)
    np.testing.assert_allclose(out, want[f"shard_map_{dtype}"], **TOL[dtype])
    np.testing.assert_allclose(out, want[f"out_{dtype}"], **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_op_matches_jax(op_run, dtype):
    """sharded_multiscale_deformable_attention, from full tensors."""
    got, want, _ = op_run
    np.testing.assert_allclose(got[f"sharded_{dtype}"], want[f"out_{dtype}"],
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("grad", ["img", "pts", "wts"])
def test_shard_map_op_gradients_match_jax(op_run, grad, dtype):
    """All three gradients through the port's shard_map op (img's partial
    over sp, summed by its DTensor) against jax.grad of the op."""
    got, want, _ = op_run
    key = f"{grad}_grad_{dtype}"
    np.testing.assert_allclose(got[key], want[key], **GRAD_TOL[dtype],
                               err_msg=key)


def test_shard_msda_args_local_blocks(op_run):
    """Each rank's local blocks (B 2 -> 1, N 64 -> 32, H 4 -> 2; the
    pyramid whole), as JAX's addressable shards are."""
    _, _, blocks = op_run
    img, shapes, pts, wts, _ = get_functional_data(B=2, H=4, N=64)
    n_pixels = img.shape[1]
    for b in blocks:
        assert b == {"img": [1, n_pixels, 2, 32],
                     "pts": [1, 32, 2, 4, 3, 2],
                     "wts": [1, 32, 2, 4, 3],
                     "out": [1, 32, 2, 32]}


def test_make_mesh_refuses_more_ranks_than_the_world():
    with pytest.raises(ValueError, match="mesh needs 2 devices"):
        make_mesh({"dp": 2}, device_type="cpu")


# --------------------------------------------------------------------------
# the train step


TRAIN_SHAPES = [(8, 8), (4, 4)]
TRAIN_MODEL = dict(num_classes=4, emb_dim=32, num_heads=4, num_points=2,
                   num_queries=8, num_encoder_layers=1, num_decoder_layers=1,
                   ffn_dim=64)
LR = 1e-2


@pytest.fixture(scope="module")
def train_run(tmp_path_factory, jax_mesh):
    """One SGD step, auction matcher: JAX's make_train_step(mesh=...) on
    its CPU mesh (tests/test_sharding.py's sharded step), and the port's on
    the gloo mesh from the same initial parameters, replicated and with
    the projections cut over tp (one spawn)."""
    d = tmp_path_factory.mktemp("train")
    shapes = np.array(TRAIN_SHAPES, np.int32)
    rng = np.random.default_rng(7)
    batch = 2
    pyramid = [rng.standard_normal((batch, h, w, 16)).astype(np.float32)
               for h, w in shapes]
    targets = {
        "labels": rng.integers(0, 3, (batch, 4)).astype(np.int32),
        "boxes": rng.random((batch, 4, 4)).astype(np.float32),
        # an uneven count of real boxes per image: the normalisers are the
        # whole batch's
        "mask": np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32),
    }
    model = JaxDetr(**TRAIN_MODEL, impl="reference", mesh=jax_mesh)
    optimizer = optax.sgd(LR)
    with jax.default_device(jax.devices("cpu")[0]):
        params = model.init(jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in pyramid], shapes)
    torch.save(state_dict_from_flax(params), d / "params.pt")
    np.savez(d / "batch.npz", **targets,
             **{f"level{i}": f for i, f in enumerate(pyramid)})
    (d / "train.json").write_text(json.dumps({
        "model": {**TRAIN_MODEL, "in_channels": [16] * len(shapes)},
        "shapes": TRAIN_SHAPES, "lr": LR}))
    run_ranks(mesh_ranks.train, RANKS, str(d), timeout=TIMEOUT)
    got = dict(np.load(d / "train_results.npz"))
    cut = json.loads((d / "cut.json").read_text())

    specs = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, float(
            "tp" in tuple(jax_tp_spec_for(path, x))), np.float32), params)
    with jax_mesh:
        p = jax_replicate(params, jax_mesh)
        o = jax_replicate(optimizer.init(p), jax_mesh)
        pyr = [jax.device_put(jnp.asarray(f), NamedSharding(
            jax_mesh, P("dp", None, None, None))) for f in pyramid]
        tgt = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            jax_mesh, P("dp", *([None] * (v.ndim - 1)))))
            for k, v in targets.items()}
        step = jax_make_train_step(model, optimizer, jax_mesh, shapes,
                                   matcher="auction", return_metrics=True)
        new_params, _, loss, metrics = step(p, o, pyr, tgt)
    want = {"loss": float(loss), "converged": bool(
        metrics["matcher_converged"]),
        "params": {k: v.numpy() for k, v in
                   state_dict_from_flax(new_params).items()},
        "split": {k for k, v in state_dict_from_flax(specs).items()
                  if bool((v == 1).all())}}
    return got, want, cut


@pytest.mark.parametrize("place", ["replicate_params", "shard_params"])
def test_sharded_train_step_loss_matches_jax(train_run, place):
    got, want, _ = train_run
    assert bool(got[f"{place}/converged"]) and want["converged"]
    np.testing.assert_allclose(float(got[f"{place}/loss"]), want["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("place", ["replicate_params", "shard_params"])
def test_sharded_train_step_parameters_match_jax(train_run, place):
    """Every parameter after the step, whole (tp blocks gathered)."""
    got, want, _ = train_run
    names = {k.split("/", 1)[1] for k in got if k.startswith(place + "/")}
    assert names - {"loss", "converged"} == set(want["params"])
    for name, w in want["params"].items():
        np.testing.assert_allclose(got[f"{place}/{name}"], w, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_shard_params_cuts_what_jax_splits(train_run):
    """shard_params cut exactly the parameters JAX's _tp_spec_for splits
    (through the flax-to-torch names), each to half along the port's
    _tp_spec_for dimension."""
    got, want, cut = train_run
    assert set(cut) == want["split"] and cut
    for name, shape in cut.items():
        whole = list(want["params"][name].shape)
        dim = _tp_spec_for(name, torch.empty(whole))
        whole[dim] //= 2
        assert shape == whole, name


def test_tp_sharded_step_equals_replicated(train_run):
    """The step with the projections cut over tp equals the step with
    every parameter whole (test_sharding.py's slow tp test)."""
    got, want, _ = train_run
    np.testing.assert_allclose(float(got["shard_params/loss"]),
                               float(got["replicate_params/loss"]),
                               rtol=1e-5)
    for name in want["params"]:
        np.testing.assert_allclose(got[f"shard_params/{name}"],
                                   got[f"replicate_params/{name}"],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# --------------------------------------------------------------------------
# the dry run


def test_dryrun_entry_point_on_cpu():
    """python -m msda_tpu_torch.dryrun --devices 8 --device cpu."""
    run = subprocess.run(
        [sys.executable, "-m", "msda_tpu_torch.dryrun", "--devices", "8",
         "--device", "cpu", "--timeout", str(TIMEOUT)],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT + 60)
    assert run.returncode == 0, run.stderr[-4000:]
    line = run.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(8): mesh dp=2 sp=2 tp=2, one "
                           "train step OK, loss="), line
    assert np.isfinite(float(line.rsplit("=", 1)[1]))
