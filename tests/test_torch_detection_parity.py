"""HuggingFace detectors with their MSDA core patched to call the port
(``msda_tpu_torch.detection_parity``), on the CPU at the small size.

* The patched HF ``MultiScaleDeformableAttention`` against the stock one at
  ``tests/test_detection_parity.py``'s op-boundary shapes (a 4-level stride
  pyramid, 300 queries, 8 heads), within 1e-5.
* ``python -m msda_tpu_torch.detection_parity --size small`` for both
  models: top-10 detections identical, boxes within 1e-3, a JSON record
  each; and the logits of the port-patched model within 1e-5 of the same
  HF model patched with the JAX script's ``patched_msda_forward
  ("reference")`` (its ``run_parity`` is not called: it probes for
  pretrained weights).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("jax")

from msda_tpu_torch import detection_parity as dp  # noqa: E402
from test_detection_parity import _decoder_shaped_inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _hf_classes():
    from transformers.models.deformable_detr import modeling_deformable_detr
    from transformers.models.grounding_dino import modeling_grounding_dino

    return {"deformable-detr": modeling_deformable_detr,
            "grounding-dino": modeling_grounding_dino}


@pytest.mark.parametrize("model", dp.MODELS)
def test_patched_hf_msda_matches_stock(model):
    cls = _hf_classes()[model].MultiScaleDeformableAttention
    shapes, value, locs, wts = _decoder_shaped_inputs()
    shapes_list = [(int(h), int(w)) for h, w in shapes]
    sizes = np.array([h * w for h, w in shapes_list])
    args = (torch.from_numpy(value), torch.from_numpy(shapes.astype(np.int64)),
            shapes_list, torch.from_numpy(np.concatenate(
                [[0], np.cumsum(sizes)[:-1]]).astype(np.int64)),
            torch.from_numpy(locs), torch.from_numpy(wts), 64)
    module = cls()
    with torch.no_grad():
        want = module(*args)
        got = dp.patched_msda_forward(cls.forward)(module, *args)
        by_name = dp.patched_msda_forward(cls.forward)(
            module, value=args[0], value_spatial_shapes=args[1],
            value_spatial_shapes_list=shapes_list, level_start_index=args[3],
            sampling_locations=args[4], attention_weights=args[5],
            im2col_step=64)
    assert got.shape == want.shape == (2, 300, 8 * 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(by_name, got, rtol=0, atol=0)


def test_unknown_signature_raises():
    def forward(self, hidden_states, mask=None):
        return hidden_states

    with pytest.raises(RuntimeError, match="unknown"):
        dp.patched_msda_forward(forward)


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity")
    return out, dp.main(["--size", "small", "--device", "cpu",
                         "--out-dir", str(out)])


@pytest.mark.parametrize("model", dp.MODELS)
def test_small_parity_top10_and_boxes(small_run, model):
    out, results = small_run
    res = results[model]
    assert res["topk_detections_identical"], res
    assert res["max_abs_boxes_diff"] < 1e-3, res
    assert res["max_abs_logits_diff"] < 1e-4, res
    assert res["k1_launches_per_forward"] == 0  # the CPU: the plain version
    assert json.loads((out / f"{model}-small.json").read_text()) == res


def _jax_patch():
    spec = importlib.util.spec_from_file_location(
        "jax_detection_parity", ROOT / "scripts" / "detection_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.patched_msda_forward("reference")


@pytest.mark.parametrize("model", dp.MODELS)
def test_port_patch_matches_jax_patch(model):
    build = dp.build_grounding_dino if model == "grounding-dino" else (
        dp.build_model)
    net = build(size="small", seed=0)
    kwargs = dp.model_inputs(model, "small", seed=0)
    with dp.patched(net):
        ours = dp.detect(net, kwargs)
    (cls,) = dp._msda_classes(net)
    stock = cls.forward
    try:
        cls.forward = _jax_patch()
        theirs = dp.detect(net, kwargs)
    finally:
        cls.forward = stock
    finite = np.isfinite(theirs["logits"])
    assert np.array_equal(np.isfinite(ours["logits"]), finite)
    np.testing.assert_allclose(ours["logits"][finite],
                               theirs["logits"][finite], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours["boxes"], theirs["boxes"], rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(ours["top_queries"], theirs["top_queries"])
    assert np.array_equal(ours["top_labels"], theirs["top_labels"])
