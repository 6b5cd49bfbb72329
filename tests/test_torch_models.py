"""The port's modules (msda_tpu_torch.models) against the JAX models on the CPU.

Each JAX module is initialised with f32 inputs, its parameters go through
``state_dict_from_flax`` into the PyTorch module, and both run the same
seeded numpy inputs (the JAX side with impl="reference").  Sizes are the
tiny configuration of ``__graft_entry__.py``: emb_dim 64, 4 heads, 2 points,
16 queries, ffn 128, a 16/8/4/2 pyramid.  Tolerance 1e-4: f32 stacks whose
matmuls and LayerNorm statistics sum in different orders.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from msda_tpu.models import MultiscaleDeformableAttention as JaxMSDA  # noqa: E402
from msda_tpu.models import detr as jax_detr  # noqa: E402
from msda_tpu_torch.models import (  # noqa: E402
    DeformableDetr,
    MultiscaleDeformableAttention,
    attention_state_dict_from_flax,
    init_parameters,
    postprocess,
    state_dict_from_flax,
)
from msda_tpu_torch.models import detr  # noqa: E402
from utils import get_module_data, make_pyramid_shapes  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = make_pyramid_shapes(4, 16)  # 16/8/4/2
I = int((SHAPES[:, 0] * SHAPES[:, 1]).sum())  # noqa: E741
EMB, HEADS, POINTS, QUERIES, FFN = 64, 4, 2, 16, 128
IN_CH = (32, 48, 32, 16)


def _np(t):
    return t.detach().numpy()


def _assert_tree_close(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                                   err_msg=path)


def _load(module, params):
    module.load_state_dict(state_dict_from_flax(params))
    return module


@pytest.mark.parametrize("coords", [2, 4])
@pytest.mark.parametrize("normalizer", ["reference", "detr"])
def test_attention_module(coords, normalizer):
    img, shapes, queries, refs = get_module_data(
        B=2, C=EMB, N=50, coords=coords, seed=coords)
    kw = dict(emb_dim=EMB, hidden_dim=EMB, num_levels=4, num_heads=HEADS,
              num_points=POINTS, offset_normalizer=normalizer)
    jmod = JaxMSDA(**kw, impl="reference")
    params = jmod.init(jax.random.PRNGKey(1), img, shapes, queries, refs)
    want = np.asarray(jmod.apply(params, img, shapes, queries, refs))

    tmod = MultiscaleDeformableAttention(**kw)
    tmod.load_state_dict(attention_state_dict_from_flax(params))
    got = tmod(torch.from_numpy(img), shapes, torch.from_numpy(queries),
               torch.from_numpy(refs))
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_attention_module_rejects_bad_reference_points():
    img, shapes, queries, refs = get_module_data(B=1, C=EMB, N=4, coords=2)
    tmod = MultiscaleDeformableAttention(EMB, EMB, 4, HEADS, POINTS)
    with pytest.raises(ValueError, match="last dim 2 or 4"):
        tmod(torch.from_numpy(img), shapes, torch.from_numpy(queries),
             torch.zeros(1, 4, 3))


def _layer_inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, I, EMB)).astype(np.float32)
    queries = rng.standard_normal((2, QUERIES, EMB)).astype(np.float32)
    boxes = rng.random((2, QUERIES, 4)).astype(np.float32) * 0.8 + 0.1
    return feats, queries, boxes


def test_encoder_layer():
    feats, _, _ = _layer_inputs(0)
    enc_refs = np.array(jax_detr.make_encoder_reference_points(SHAPES))
    kw = dict(emb_dim=EMB, num_levels=4, num_heads=HEADS, num_points=POINTS,
              ffn_dim=FFN)
    jl = jax_detr.DeformableEncoderLayer(**kw, impl="reference")
    params = jl.init(jax.random.PRNGKey(2), feats, SHAPES, enc_refs)
    want = np.asarray(jl.apply(params, feats, SHAPES, enc_refs))
    tl = _load(detr.DeformableEncoderLayer(**kw), params)
    got = tl(torch.from_numpy(feats), SHAPES, torch.from_numpy(enc_refs))
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_decoder_layer():
    feats, queries, boxes = _layer_inputs(1)
    kw = dict(emb_dim=EMB, num_levels=4, num_heads=HEADS, num_points=POINTS,
              ffn_dim=FFN)
    jl = jax_detr.DeformableDecoderLayer(**kw, impl="reference")
    params = jl.init(jax.random.PRNGKey(3), queries, feats, SHAPES, boxes)
    want = np.asarray(jl.apply(params, queries, feats, SHAPES, boxes))
    tl = _load(detr.DeformableDecoderLayer(**kw), params)
    got = tl(torch.from_numpy(queries), torch.from_numpy(feats), SHAPES,
             torch.from_numpy(boxes))
    np.testing.assert_allclose(_np(got), want, **TOL)


def _pyramid(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, h, w, c)).astype(np.float32)
            for (h, w), c in zip(SHAPES, IN_CH)]


def _detr_kw(refine, two_stage):
    return dict(num_classes=8, emb_dim=EMB, num_heads=HEADS,
                num_points=POINTS, num_queries=QUERIES,
                num_encoder_layers=2, num_decoder_layers=2, ffn_dim=FFN,
                with_box_refinement=refine, two_stage=two_stage)


@pytest.fixture(scope="module", params=[(False, False), (True, True)],
                ids=["plain", "refine_two_stage"])
def jax_detr_run(request):
    """One JAX init + apply per variant, shared by this module's tests."""
    refine, two_stage = request.param
    pyr = _pyramid(0)
    model = jax_detr.DeformableDetr(**_detr_kw(refine, two_stage),
                                    impl="reference")
    params = model.init(jax.random.PRNGKey(4), [jnp.asarray(p) for p in pyr],
                        SHAPES)
    out = model.apply(params, [jnp.asarray(p) for p in pyr], SHAPES)
    out = jax.tree.map(np.asarray, out)
    return request.param, params, pyr, out


def _torch_detr(variant, params):
    model = DeformableDetr(**_detr_kw(*variant), in_channels=IN_CH)
    return _load(model, params).eval()


def test_detr_matches_jax(jax_detr_run):
    variant, params, pyr, want = jax_detr_run
    model = _torch_detr(variant, params)
    with torch.no_grad():
        got = model([torch.from_numpy(p) for p in pyr], SHAPES)
    _assert_tree_close(got, want)


def test_state_dict_from_flax_uses_every_leaf_once(jax_detr_run):
    variant, params, _, _ = jax_detr_run
    leaves = jax.tree_util.tree_leaves(params)
    model = DeformableDetr(**_detr_kw(*variant), in_channels=IN_CH)
    sd = state_dict_from_flax(params)
    model.load_state_dict(sd)  # strict: every module key is filled
    assert len(sd) == len(leaves) == len(model.state_dict())
    assert sum(t.numel() for t in sd.values()) == sum(
        np.asarray(x).size for x in leaves)

    tree = jax.tree.map(np.asarray, params["params"])
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        state_dict_from_flax(extra)
    missing = dict(tree)
    missing["class_head"] = {"kernel": tree["class_head"]["kernel"]}
    with pytest.raises(ValueError, match="missing"):
        state_dict_from_flax(missing)
    no_head = {k: v for k, v in tree.items() if k != "box_head"}
    with pytest.raises(RuntimeError, match="box_head"):
        model.load_state_dict(state_dict_from_flax(no_head))


def test_postprocess_matches_jax_on_model_outputs(jax_detr_run):
    _, _, _, out = jax_detr_run
    sizes = np.array([[480, 640], [600, 800]], np.int32)
    t_out = {k: torch.from_numpy(out[k]) for k in ("logits", "boxes")}
    for scoring in ("softmax", "sigmoid"):
        for image_sizes in (None, sizes):
            want = jax_detr.postprocess(out, top_k=10, scoring=scoring,
                                        image_sizes=image_sizes)
            got = postprocess(t_out, top_k=10, scoring=scoring,
                              image_sizes=image_sizes)
            np.testing.assert_array_equal(_np(got["labels"]),
                                          np.asarray(want["labels"]))
            for k in ("scores", "boxes"):
                np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                           **TOL, err_msg=k)


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
@pytest.mark.parametrize("with_sizes", [False, True])
def test_postprocess(scoring, with_sizes):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 12, 6)).astype(np.float32)
    boxes = rng.random((2, 12, 4)).astype(np.float32)
    sizes = np.array([[100, 200], [300, 50]], np.int32) if with_sizes else None
    want = jax_detr.postprocess({"logits": logits, "boxes": boxes}, top_k=20,
                                scoring=scoring, image_sizes=sizes)
    got = postprocess({"logits": torch.from_numpy(logits),
                       "boxes": torch.from_numpy(boxes)}, top_k=20,
                      scoring=scoring, image_sizes=sizes)
    np.testing.assert_array_equal(_np(got["labels"]),
                                  np.asarray(want["labels"]))
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL)
    with pytest.raises(ValueError, match="scoring"):
        postprocess({"logits": torch.from_numpy(logits),
                     "boxes": torch.from_numpy(boxes)}, scoring="argmax")


@pytest.mark.parametrize("helper", ["anchors", "reference_points"])
def test_pyramid_helpers(helper):
    shapes = np.array([(6, 10), (3, 5), (2, 3)], np.int32)
    if helper == "anchors":
        want = jax_detr.make_proposal_anchors(shapes)
        got = detr.make_proposal_anchors(shapes)
    else:
        want = jax_detr.make_encoder_reference_points(shapes)
        got = detr.make_encoder_reference_points(shapes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_init_parameters_is_seeded():
    def make(seed):
        m = DeformableDetr(**_detr_kw(True, False), in_channels=IN_CH)
        return init_parameters(m, torch.Generator().manual_seed(seed))

    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["class_head.weight"], c["class_head.weight"])
    assert torch.equal(a["encoder_layers.0.norm_0.weight"],
                       torch.ones(EMB))


def test_bf16_compute_dtype_runs_on_cpu():
    """The bf16 serving policy: f32 parameters, bf16 stack, f32 heads."""
    model = DeformableDetr(**_detr_kw(True, True), in_channels=IN_CH,
                           compute_dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = model([torch.from_numpy(p) for p in _pyramid(1)], SHAPES)
        det = postprocess(out, top_k=5, scoring="sigmoid",
                          image_sizes=[[64, 64], [32, 48]])
    assert out["logits"].dtype == torch.float32
    assert out["logits"].shape == (2, QUERIES, 8)
    assert out["boxes"].shape == (2, QUERIES, 4)
    assert torch.isfinite(out["logits"]).all()
    assert torch.isfinite(det["boxes"]).all()
    assert det["scores"].shape == (2, 5)
