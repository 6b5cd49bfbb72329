"""Model components built on the MSDA op."""

from .attention import MultiscaleDeformableAttention
from .convert import (
    attention_state_dict_from_flax,
    attention_state_dict_from_hf,
    attention_state_dict_from_torch,
    attention_state_dict_to_torch,
    state_dict_from_flax,
)
from .detr import DeformableDetr, init_parameters, postprocess

__all__ = [
    "MultiscaleDeformableAttention",
    "DeformableDetr",
    "init_parameters",
    "postprocess",
    "state_dict_from_flax",
    "attention_state_dict_from_flax",
    "attention_state_dict_from_torch",
    "attention_state_dict_from_hf",
    "attention_state_dict_to_torch",
]
