"""Weight bridges into the PyTorch modules: from the JAX (flax) models, from
msda-triton's module and from HuggingFace's Deformable DETR attention.

``state_dict_from_flax`` turns the flax parameter tree of
``msda_tpu.models.DeformableDetr`` (or of any of its submodules) into a
``state_dict`` for the matching module of this package, so that both
packages can run the same weights.  The tree's leaves may be numpy arrays
or anything ``np.asarray`` accepts; JAX is not imported here.

Mapping:
    Dense ``kernel [in, out]``           -> Linear ``weight = kernel.T``
    LayerNorm ``scale``                  -> ``weight``
    MHA ``query/key/value`` ``kernel [D, H, Dh]``, ``bias [H, Dh]``
                                         -> ``weight [H*Dh, D]``, ``bias [H*Dh]``
    MHA ``out`` ``kernel [H, Dh, D]``    -> ``weight [D, H*Dh]``
    ``level_embedding``, ``query_embedding``, ``reference_box_logits``
                                         -> the same names, unchanged
and flax's module names to this package's attributes:
    ``input_proj_<l>`` -> ``input_proj.<l>``, ``encoder_layer_<i>`` ->
    ``encoder_layers.<i>``, ``decoder_layer_<i>`` -> ``decoder_layers.<i>``,
    ``box_refine_<i>`` -> ``box_refine.<i>``, ``aux_class_<i>`` ->
    ``aux_class.<i>``, ``MultiscaleDeformableAttention_0`` -> ``msda``,
    ``MultiHeadDotProductAttention_0`` -> ``self_attn``, ``_FFN_0`` ->
    ``ffn``, ``LayerNorm_<k>`` -> ``norm_<k>``, ``Dense_<k>`` -> ``dense_<k>``.

Every flax leaf is used exactly once: a leaf the mapping does not know, or
a module that lacks one of its leaves, raises ``ValueError``.

The loaders of ``msda_tpu/models/convert.py``, for
:class:`msda_tpu_torch.models.MultiscaleDeformableAttention`, whose
``state_dict`` keys are msda-triton's: :func:`attention_state_dict_from_torch`
(an msda-triton ``state_dict``, or a submodule's inside a larger one),
:func:`attention_state_dict_from_hf` (HuggingFace's
``DeformableDetrMultiscaleDeformableAttention``: pretrained Deformable
DETR and Grounding DINO weights) and :func:`attention_state_dict_to_torch`,
the inverse of the first.  Their tensors keep the inputs' values and
dtypes, as ``nn.Linear``'s ``[out, in]`` weights and ``[out]`` biases.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "state_dict_from_flax",
    "attention_state_dict_from_flax",
    "attention_state_dict_from_torch",
    "attention_state_dict_from_hf",
    "attention_state_dict_to_torch",
]

_RAW_PARAMS = ("level_embedding", "query_embedding", "reference_box_logits")
_PROJS = ("img_input_proj", "query_input_proj", "query_output_proj")
_FIXED_NAMES = {
    "MultiscaleDeformableAttention_0": "msda",
    "MultiHeadDotProductAttention_0": "self_attn",
    "_FFN_0": "ffn",
}
_INDEXED_NAMES = (
    (re.compile(r"^input_proj_(\d+)$"), "input_proj.{}"),
    (re.compile(r"^encoder_layer_(\d+)$"), "encoder_layers.{}"),
    (re.compile(r"^decoder_layer_(\d+)$"), "decoder_layers.{}"),
    (re.compile(r"^box_refine_(\d+)$"), "box_refine.{}"),
    (re.compile(r"^aux_class_(\d+)$"), "aux_class.{}"),
    (re.compile(r"^LayerNorm_(\d+)$"), "norm_{}"),
    (re.compile(r"^Dense_(\d+)$"), "dense_{}"),
)


def _torch_name(flax_name: str) -> str:
    if flax_name in _FIXED_NAMES:
        return _FIXED_NAMES[flax_name]
    for pattern, fmt in _INDEXED_NAMES:
        m = pattern.match(flax_name)
        if m:
            return fmt.format(m.group(1))
    return flax_name


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _leaf_module(path: str, node: Mapping) -> dict[str, torch.Tensor]:
    """Convert one flax Dense / DenseGeneral / LayerNorm parameter dict."""
    keys = set(node)
    if "scale" in keys:
        expected = {"scale", "bias"}
    else:
        expected = {"kernel", "bias"}
    if keys != expected:
        raise ValueError(
            f"{path or '<root>'}: expected leaves {sorted(expected)}, got "
            f"{sorted(keys)} (missing {sorted(expected - keys)}, "
            f"left over {sorted(keys - expected)})"
        )
    bias = np.asarray(node["bias"])
    if "scale" in keys:
        return {"weight": _tensor(node["scale"]), "bias": _tensor(bias)}
    kernel = np.asarray(node["kernel"])
    if kernel.ndim == 2:  # Dense [in, out]
        weight = kernel.T
    elif kernel.ndim == 3 and bias.ndim == 2:  # MHA query/key/value [D, H, Dh]
        weight = kernel.reshape(kernel.shape[0], -1).T
        bias = bias.reshape(-1)
    elif kernel.ndim == 3:  # MHA out [H, Dh, D]
        weight = kernel.reshape(-1, kernel.shape[-1]).T
    else:
        raise ValueError(f"{path}: unexpected kernel shape {kernel.shape}")
    return {"weight": _tensor(weight), "bias": _tensor(bias)}


def _walk(node: Mapping, prefix: str, out: dict[str, torch.Tensor]) -> None:
    if "kernel" in node or "scale" in node:
        for k, v in _leaf_module(prefix.rstrip("."), node).items():
            out[prefix + k] = v
        return
    for name, child in node.items():
        if isinstance(child, Mapping):
            _walk(child, f"{prefix}{_torch_name(name)}.", out)
        elif name in _RAW_PARAMS and not prefix:
            out[name] = _tensor(child)
        else:
            raise ValueError(
                f"flax leaf {prefix}{name} has no counterpart in the "
                "PyTorch modules"
            )


def _count_leaves(node) -> int:
    if isinstance(node, Mapping):
        return sum(_count_leaves(v) for v in node.values())
    return 1


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax params (``{"params": tree}`` or the tree) -> ``state_dict``.

    Load the result with ``module.load_state_dict`` (strict), which raises
    on keys the module has that the params lack, and on wrong shapes.
    """
    tree = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    _walk(tree, "", out)
    if len(out) != _count_leaves(tree):  # one key per leaf, no collisions
        raise ValueError(
            f"{_count_leaves(tree)} flax leaves mapped to {len(out)} keys"
        )
    return out


def attention_state_dict_from_flax(params: Mapping
                                   ) -> dict[str, torch.Tensor]:
    """flax ``MultiscaleDeformableAttention`` params -> ``state_dict`` of
    :class:`msda_tpu_torch.models.MultiscaleDeformableAttention`."""
    tree = params.get("params", params)
    if set(tree) != set(_PROJS):
        raise ValueError(
            f"expected exactly the projections {list(_PROJS)}, got "
            f"{sorted(tree)}"
        )
    return state_dict_from_flax(tree)


def _linear_pair(state_dict: Mapping, prefix: str, name: str):
    """``(weight, bias)`` of the ``nn.Linear`` ``prefix + name``, copied to
    new tensors and checked to be ``[out, in]`` and ``[out]``."""
    wk, bk = f"{prefix}{name}.weight", f"{prefix}{name}.bias"
    missing = [k for k in (wk, bk) if k not in state_dict]
    if missing:
        raise KeyError(
            f"state_dict is missing {missing}; available keys with this "
            f"prefix: {[k for k in state_dict if k.startswith(prefix)][:8]}"
        )
    w, b = (state_dict[k].detach().clone()
            if isinstance(state_dict[k], torch.Tensor)
            else _tensor(state_dict[k]) for k in (wk, bk))
    if w.ndim != 2 or b.ndim != 1 or w.shape[0] != b.shape[0]:
        raise ValueError(
            f"{name}: expected weight [out, in] and bias [out], got "
            f"{tuple(w.shape)} / {tuple(b.shape)}"
        )
    return w, b


def attention_state_dict_from_torch(state_dict: Mapping, prefix: str = ""
                                    ) -> dict[str, torch.Tensor]:
    """msda-triton ``MultiscaleDeformableAttention.state_dict()`` ->
    ``state_dict`` of :class:`msda_tpu_torch.models.MultiscaleDeformableAttention`.

    The keys are the same; ``prefix`` selects a submodule inside a larger
    ``state_dict`` (e.g. ``"decoder.layers.0.cross_attn."``, trailing dot
    included) and is stripped.  Raises ``KeyError`` on a missing weight or
    bias and ``ValueError`` on a weight that is not ``[out, in]`` or a bias
    that is not ``[out]``.
    """
    out = {}
    for name in _PROJS:
        w, b = _linear_pair(state_dict, prefix, name)
        out[f"{name}.weight"], out[f"{name}.bias"] = w, b
    return out


def attention_state_dict_from_hf(state_dict: Mapping, num_heads: int,
                                 num_levels: int, num_points: int,
                                 prefix: str = "") -> dict[str, torch.Tensor]:
    """HuggingFace ``DeformableDetrMultiscaleDeformableAttention`` weights ->
    ``state_dict`` of :class:`msda_tpu_torch.models.MultiscaleDeformableAttention`.

    HuggingFace projects the queries with two Linears,
    ``sampling_offsets`` (``[H*L*P*2]`` rows) and ``attention_weights``
    (``[H*L*P]``); this package with one, ``query_input_proj``, whose
    ``[H*L*P*3]`` rows hold (x offset, y offset, weight logit) per (head,
    level, point).  So the rows are interleaved: row ``((h*L + l)*P + p)*3
    + {0, 1}`` is an offset, ``+ 2`` the logit.  ``value_proj`` maps to
    ``img_input_proj`` and ``output_proj`` to ``query_output_proj``.

    Use the result with a module configured to HuggingFace's semantics:
    ``offset_normalizer="detr"``, ``padding_mode="zeros"``,
    ``align_corners=False``.  ``prefix`` selects the attention submodule of
    a full model (e.g. ``"model.decoder.layers.0.encoder_attn."``).
    """
    H, L, P = int(num_heads), int(num_levels), int(num_points)
    off_w, off_b = _linear_pair(state_dict, prefix, "sampling_offsets")
    attn_w, attn_b = _linear_pair(state_dict, prefix, "attention_weights")
    val_w, val_b = _linear_pair(state_dict, prefix, "value_proj")
    out_w, out_b = _linear_pair(state_dict, prefix, "output_proj")
    emb = off_w.shape[1]
    if off_w.shape[0] != H * L * P * 2 or attn_w.shape[0] != H * L * P:
        raise ValueError(
            f"weight rows {off_w.shape[0]}/{attn_w.shape[0]} do not match "
            f"num_heads*num_levels*num_points = {H}*{L}*{P}"
        )
    wq = torch.cat([off_w.reshape(H * L * P, 2, emb),
                    attn_w.reshape(H * L * P, 1, emb)], 1)
    bq = torch.cat([off_b.reshape(H * L * P, 2),
                    attn_b.reshape(H * L * P, 1)], 1)
    return {
        "img_input_proj.weight": val_w,
        "img_input_proj.bias": val_b,
        "query_input_proj.weight": wq.reshape(H * L * P * 3, emb),
        "query_input_proj.bias": bq.reshape(H * L * P * 3),
        "query_output_proj.weight": out_w,
        "query_output_proj.bias": out_b,
    }


def attention_state_dict_to_torch(state_dict: Mapping, prefix: str = ""
                                  ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`attention_state_dict_from_torch`: the module's
    ``state_dict`` -> msda-triton's, with ``prefix`` prepended to every
    key."""
    out = {}
    for name in _PROJS:
        w, b = _linear_pair(state_dict, "", name)
        out[f"{prefix}{name}.weight"], out[f"{prefix}{name}.bias"] = w, b
    return out
