"""The port's weight loaders (``msda_tpu_torch.models.convert``) against the
JAX package's (``msda_tpu.models.convert``) on the CPU.

The cases of ``tests/test_convert.py``: the loaded ``state_dict`` fits the
attention module (strict), each projection equals
``torch.nn.functional.linear`` of the msda-triton weights, the round trip
through ``attention_state_dict_to_torch``, and missing keys and bad shapes
raise as the JAX loader raises.  The HuggingFace loader against
``attention_params_from_hf`` on the same numpy ``state_dict``: the same
interleaved weights, and the port module and the flax module agree within
1e-5 (f32, HuggingFace's semantics: ``offset_normalizer="detr"``, zeros
padding).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from msda_tpu.models import MultiscaleDeformableAttention as JaxMSDA  # noqa: E402
from msda_tpu.models import attention_params_from_hf, attention_params_from_torch  # noqa: E402
from msda_tpu_torch.models import (  # noqa: E402
    MultiscaleDeformableAttention,
    attention_state_dict_from_flax,
    attention_state_dict_from_hf,
    attention_state_dict_from_torch,
    attention_state_dict_to_torch,
)

EMB, HID, L, H, P = 32, 32, 2, 4, 2
PROJS = ("img_input_proj", "query_input_proj", "query_output_proj")


def _torch_state(seed=0, prefix=""):
    g = torch.Generator().manual_seed(seed)
    sizes = {
        "img_input_proj": (HID, EMB),
        "query_input_proj": (H * L * P * 3, EMB),
        "query_output_proj": (EMB, HID),
    }
    sd = {}
    for name, (out, inp) in sizes.items():
        sd[f"{prefix}{name}.weight"] = torch.randn(out, inp, generator=g)
        sd[f"{prefix}{name}.bias"] = torch.randn(out, generator=g)
    return sd


def _hf_state(seed=3):
    rng = np.random.default_rng(seed)
    sizes = {"sampling_offsets": (H * L * P * 2, EMB),
             "attention_weights": (H * L * P, EMB),
             "value_proj": (EMB, EMB), "output_proj": (EMB, EMB)}
    sd = {}
    for name, (out, inp) in sizes.items():
        sd[f"model.layers.0.attn.{name}.weight"] = (
            rng.standard_normal((out, inp)) * 0.1).astype(np.float32)
        sd[f"model.layers.0.attn.{name}.bias"] = (
            rng.standard_normal(out) * 0.1).astype(np.float32)
    return sd


def _module(**kw):
    return MultiscaleDeformableAttention(
        emb_dim=EMB, hidden_dim=HID, num_levels=L, num_heads=H,
        num_points=P, impl="reference", **kw)


@pytest.mark.parametrize("prefix", ["", "decoder.layers.0.cross_attn."])
def test_structure_matches_the_module(prefix):
    sd = _torch_state(prefix=prefix)
    sd["decoder.norm.weight"] = torch.ones(EMB)  # another module's key
    converted = attention_state_dict_from_torch(sd, prefix=prefix)
    module = _module()
    module.load_state_dict(converted)  # strict: every key, every shape
    assert set(converted) == set(module.state_dict())
    for k, v in module.state_dict().items():
        assert v.shape == converted[k].shape and v.dtype == converted[k].dtype
    rng = np.random.default_rng(0)
    out = module(torch.from_numpy(rng.standard_normal((1, 20, EMB),
                                                      dtype=np.float32)),
                 ((4, 4), (2, 2)),
                 torch.from_numpy(rng.standard_normal((1, 3, EMB),
                                                      dtype=np.float32)),
                 torch.from_numpy(rng.random((1, 3, 2), dtype=np.float32)))
    assert out.shape == (1, 3, EMB) and torch.isfinite(out).all()


def test_each_projection_matches_torch_linear():
    sd = _torch_state(seed=1)
    module = _module()
    module.load_state_dict(attention_state_dict_from_torch(sd))
    rng = np.random.default_rng(1)
    for name in PROJS:
        w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
        x = torch.from_numpy(rng.standard_normal((5, w.shape[1]),
                                                 dtype=np.float32))
        assert torch.equal(getattr(module, name)(x), F.linear(x, w, b))


def test_matches_the_jax_loader():
    """The same msda-triton weights, loaded by the port and by the JAX
    package (then bridged with ``attention_state_dict_from_flax``), give
    the same tensors."""
    sd = _torch_state(seed=4)
    via_jax = attention_state_dict_from_flax(
        jax.tree.map(np.asarray, attention_params_from_torch(sd)))
    port = attention_state_dict_from_torch(sd)
    assert set(port) == set(via_jax)
    for k in port:
        assert torch.equal(port[k], via_jax[k]), k


@pytest.mark.parametrize("prefix", ["", "encoder.layers.3.attn."])
def test_round_trip_inverse(prefix):
    sd = _torch_state(seed=2, prefix=prefix)
    converted = attention_state_dict_from_torch(sd, prefix=prefix)
    back = attention_state_dict_to_torch(converted, prefix=prefix)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v)
    again = attention_state_dict_from_torch(back, prefix=prefix)
    for k, v in converted.items():
        assert torch.equal(again[k], v)
    back[f"{prefix}img_input_proj.weight"].zero_()  # a copy, not a view
    assert not torch.equal(converted["img_input_proj.weight"],
                           back[f"{prefix}img_input_proj.weight"])


def test_missing_key_error():
    sd = _torch_state()
    del sd["query_output_proj.bias"]
    with pytest.raises(KeyError, match="query_output_proj"):
        attention_state_dict_from_torch(sd)
    with pytest.raises(KeyError, match="img_input_proj"):
        attention_state_dict_from_torch(_torch_state(), prefix="other.")


@pytest.mark.parametrize("key,shape", [
    ("img_input_proj.weight", (HID * EMB,)),
    ("query_output_proj.bias", (EMB, 1)),
    ("query_input_proj.bias", (7,)),
])
def test_bad_shape_error(key, shape):
    sd = _torch_state()
    sd[key] = torch.zeros(shape)
    with pytest.raises(ValueError, match="expected weight"):
        attention_state_dict_from_torch(sd)


def test_hf_loader_matches_the_jax_loader():
    """HuggingFace weights through both packages' loaders: the same
    interleaved ``query_input_proj``, and the port module and the flax
    module agree within 1e-5 on the same inputs."""
    hf = _hf_state()
    prefix = "model.layers.0.attn."
    port_sd = attention_state_dict_from_hf(hf, H, L, P, prefix=prefix)
    params = attention_params_from_hf(hf, H, L, P, prefix=prefix)
    via_jax = attention_state_dict_from_flax(jax.tree.map(np.asarray,
                                                          params))
    for k in port_sd:
        assert torch.equal(port_sd[k], via_jax[k]), k
    assert torch.equal(port_sd["img_input_proj.weight"],
                       torch.from_numpy(hf[prefix + "value_proj.weight"]))
    # row ((h*L + l)*P + p)*3 + 2 is the attention logit of (h, l, p)
    assert torch.equal(
        port_sd["query_input_proj.weight"][2::3],
        torch.from_numpy(hf[prefix + "attention_weights.weight"]))

    kw = dict(padding_mode="zeros", align_corners=False,
              offset_normalizer="detr")
    module = _module(**kw)
    module.load_state_dict(port_sd)
    jmod = JaxMSDA(emb_dim=EMB, hidden_dim=HID, num_levels=L, num_heads=H,
                   num_points=P, impl="reference", **kw)
    rng = np.random.default_rng(5)
    shapes = ((6, 5), (3, 3))
    img = rng.standard_normal((2, 39, EMB)).astype(np.float32)
    queries = rng.standard_normal((2, 7, EMB)).astype(np.float32)
    refs = rng.random((2, 7, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmod.apply(params, jnp.asarray(img),
                                     np.asarray(shapes, np.int32),
                                     jnp.asarray(queries),
                                     jnp.asarray(refs)))
    with torch.no_grad():
        got = module(torch.from_numpy(img), shapes,
                     torch.from_numpy(queries), torch.from_numpy(refs))
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_hf_loader_checks_the_rows():
    with pytest.raises(ValueError, match="do not match"):
        attention_state_dict_from_hf(_hf_state(), H, L, P + 1,
                                     prefix="model.layers.0.attn.")
    with pytest.raises(KeyError, match="sampling_offsets"):
        attention_state_dict_from_hf(_hf_state(), H, L, P)
