"""Weight bridge from the JAX (flax) models to the PyTorch modules.

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

The loaders of msda-triton and HuggingFace ``state_dict``s
(``msda_tpu/models/convert.py``) are not ported yet.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "attention_state_dict_from_flax"]

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
