"""Ahead-of-time export (``msda_tpu_torch.utils.export``) against the JAX
package's ``jax.export`` round trips, on the CPU.

The counterparts of ``tests/test_export.py``: the bare op, here through the
custom operator ``torch.ops.msda_tpu_torch.msda_fwd`` on CPU tensors, and
the small two-stage detector with box refinement plus ``postprocess``,
loaded from the flax parameters through ``state_dict_from_flax``, saved to
disk and served by a fresh Python process that imports only
``msda_tpu_torch``.  Both are compared with the JAX package's
``export_fn`` / ``load_exported`` (or ``jax.jit``) of
``impl="reference"`` on the same numpy inputs, in explicit f32 arrays
(``conftest.py`` turns on x64): the op within 1e-6, the detector's labels
equal and its scores and boxes within 1e-5.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from msda_tpu.models.detr import DeformableDetr as JaxDetr  # noqa: E402
from msda_tpu.models.detr import postprocess as jax_postprocess  # noqa: E402
from msda_tpu.ops import multiscale_deformable_attention as jax_msda  # noqa: E402
from msda_tpu.utils import export_fn as jax_export_fn  # noqa: E402
from msda_tpu.utils import load_exported as jax_load_exported  # noqa: E402
from msda_tpu_torch.models import DeformableDetr, postprocess, state_dict_from_flax  # noqa: E402
from msda_tpu_torch.ops import library  # noqa: E402
from msda_tpu_torch.utils import (export_fn, load_exported,  # noqa: E402
                                  load_exported_file, save_exported)
from msda_tpu_torch.utils.export import _FRAME_CHUNK_SLOTS, _own_frame_chunk  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 8), (4, 4))
IN_CH = (16, 16)


def _op_inputs():
    rng = np.random.default_rng(0)
    I = sum(h * w for h, w in SHAPES)  # noqa: E741
    img = rng.standard_normal((2, I, 2, 8)).astype(np.float32)
    pts = rng.random((2, 10, 2, 2, 3, 2)).astype(np.float32)
    logits = rng.standard_normal((2, 10, 2, 2, 3)).astype(np.float32)
    wts = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return img, pts, wts.astype(np.float32)


def test_export_op_round_trip(cpu_device, tmp_path):
    img, pts, wts = _op_inputs()
    flat = library.flat_shapes(SHAPES)

    def fn(i, p, w):
        return library.msda_fwd(i, p, w, flat, "border", False)

    blob = export_fn(fn, *(torch.from_numpy(a) for a in (img, pts, wts)))
    path = tmp_path / "op.pt2"
    save_exported(blob, path)
    served = load_exported_file(path)
    assert "msda_tpu_torch.msda_fwd" in str(served.graph)
    got = served(*(torch.from_numpy(a) for a in (img, pts, wts)))
    again = load_exported(blob)(*(torch.from_numpy(a)
                                  for a in (img, pts, wts)))
    assert torch.equal(got, again)

    def jfn(i, p, w):
        return jax_msda(i, np.asarray(SHAPES, np.int32), p, w, "border",
                        False, impl="reference")

    with jax.default_device(cpu_device):
        jblob = jax_export_fn(jfn, img, pts, wts, platforms=("cpu",))
        want = np.asarray(jax_load_exported(jblob)(img, pts, wts))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


_SERVE = """
import json, sys
sys.path.insert(0, sys.argv[2])
import numpy as np
import torch
from msda_tpu_torch.utils.export import load_exported_file

d = sys.argv[1]
serve = load_exported_file(d + "/detector.pt2")
pyramid = [torch.from_numpy(np.load(f"{d}/p{i}.npy")) for i in range(2)]
with torch.inference_mode():
    det = serve(*pyramid)
for k, v in det.items():
    np.save(f"{d}/{k}.npy", v.numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "msda_tpu"))))
"""


def test_export_detector_with_postprocess(cpu_device, tmp_path):
    """The serving pipeline (detector forward + top-k decode) exported as
    one artifact, saved, served by a fresh process, and equal to the live
    port model and to the JAX model under ``jax.jit``."""
    kw = dict(num_classes=5, emb_dim=32, num_heads=4, num_points=2,
              num_queries=8, num_encoder_layers=1, num_decoder_layers=1,
              ffn_dim=64, with_box_refinement=True, two_stage=True)
    rng = np.random.default_rng(1)
    pyramid = [rng.standard_normal((1, h, w, c)).astype(np.float32)
               for (h, w), c in zip(SHAPES, IN_CH)]
    jmodel = JaxDetr(**kw, impl="reference")
    jshapes = np.asarray(SHAPES, np.int32)

    def jserve(params, *pyr):
        return jax_postprocess(jmodel.apply(params, list(pyr), jshapes),
                               top_k=5)

    with jax.default_device(cpu_device):
        params = jmodel.init(jax.random.PRNGKey(0),
                             [jnp.asarray(p) for p in pyramid], jshapes)
        want = jax.tree.map(np.asarray, jax.jit(jserve)(params, *pyramid))

    model = DeformableDetr(**kw, in_channels=IN_CH, impl="reference")
    model.load_state_dict(state_dict_from_flax(params))
    model.eval()

    def serve(*pyr):
        return postprocess(model(list(pyr), SHAPES), top_k=5)

    tensors = [torch.from_numpy(p) for p in pyramid]
    save_exported(export_fn(serve, *tensors), tmp_path / "detector.pt2")
    for i, p in enumerate(pyramid):
        np.save(tmp_path / f"p{i}.npy", p)
    with torch.inference_mode():
        live = {k: v.numpy() for k, v in serve(*tensors).items()}

    run = subprocess.run([sys.executable, "-c", _SERVE, str(tmp_path), ROOT],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []
    got = {k: np.load(tmp_path / f"{k}.npy")
           for k in ("scores", "labels", "boxes")}

    assert got["scores"].shape == (1, 5)
    for ref in (live, want):
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        for k in ("scores", "boxes"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)


# load_exported gives the generated forward a frame-stack chunk of its own:
# dead locals pad its frame past CPython's 16 KiB chunk (a frame that fits
# in the caller's chunk with too little room left made each operator call
# allocate and free a chunk; PERF.md §6)
def test_loaded_forward_fills_a_frame_chunk(cpu_device):
    img, pts, wts = _op_inputs()
    flat = library.flat_shapes(SHAPES)
    args = tuple(torch.from_numpy(a) for a in (img, pts, wts))
    blob = export_fn(lambda i, p, w: library.msda_fwd(i, p, w, flat,
                                                      "border", False) * 2,
                     *args)
    plain = torch.export.load(io.BytesIO(blob)).module()
    served = load_exported(blob)
    before = type(plain).forward.__code__
    after = type(served).forward.__code__
    assert before.co_nlocals + before.co_stacksize < _FRAME_CHUNK_SLOTS
    assert after.co_nlocals + after.co_stacksize >= _FRAME_CHUNK_SLOTS
    assert "if False: _frame_pad_0 = " in served.code
    # the same graph: the same operators on the same nodes, bit for bit
    assert str(served.graph) == str(plain.graph)
    assert torch.equal(served(*args), plain(*args))


def test_own_frame_chunk_leaves_large_frames_and_other_modules():
    class Chain(torch.nn.Module):
        def forward(self, x):
            for _ in range(_FRAME_CHUNK_SLOTS + 10):
                x = x + 1
            return x

    traced = torch.fx.symbolic_trace(Chain())
    code = traced.code
    assert _own_frame_chunk(traced) is traced and traced.code == code
    linear = torch.nn.Linear(2, 2)
    assert _own_frame_chunk(linear) is linear
