"""The weights of the DINO detector (``DeformableDetr(two_stage="dino")``),
made from the seed on the run's device, as the official DINO initialises
them but for the weights that training moves off zero (``inputs.MOVED``,
as in the other configurations): the configuration's ``assumed`` and
``departures`` say which.  The kinds are ``inputs.detector_spec``'s."""

from __future__ import annotations

import math

import torch

from . import inputs


def detector_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every parameter of the DINO detector,
    under the names of its ``state_dict``."""
    D, F, H, L, P = (cfg["emb_dim"], cfg["ffn_dim"], cfg["num_heads"],
                     cfg["num_levels"], cfg["num_points"])
    K, Q = cfg["num_classes"], cfg["num_queries"]
    spec = []

    def linear(name, n_in, n_out, weight="xavier", bias="zero"):
        spec.append((f"{name}.weight", (n_out, n_in), weight))
        spec.append((f"{name}.bias", (n_out,), bias))

    def norm(name):
        spec.append((f"{name}.weight", (D,), "one"))
        spec.append((f"{name}.bias", (D,), "zero"))

    def msda(name):
        linear(f"{name}.img_input_proj", D, D)
        linear(f"{name}.query_input_proj", D, H * L * P * 3, "moved", "grid")
        linear(f"{name}.query_output_proj", D, D)

    def ffn(name):
        linear(f"{name}.dense_0", D, F, bias="fan_in")
        linear(f"{name}.dense_1", F, D, bias="fan_in")
        norm(f"{name}.norm_0")

    def box_mlp(name):
        linear(f"{name}.layers.0", D, D, "fan_in", "fan_in")
        linear(f"{name}.layers.1", D, D, "fan_in", "fan_in")
        linear(f"{name}.layers.2", D, 4, "moved")

    spec.append(("level_embedding", (L, D), "normal"))
    spec.append(("query_embedding", (Q, D), "xavier"))
    for lvl, c in enumerate(cfg["in_channels"]):
        linear(f"input_proj.{lvl}", c, D)
    for i in range(cfg["num_encoder_layers"]):
        msda(f"encoder_layers.{i}.msda")
        norm(f"encoder_layers.{i}.norm_0")
        ffn(f"encoder_layers.{i}.ffn")
    linear("enc_output", D, D)
    norm("enc_output_norm")
    linear("enc_class_head", D, K, "fan_in", "prior")
    box_mlp("enc_box_head")
    linear("ref_point_head.layers.0", 2 * D, D, bias="fan_in")
    linear("ref_point_head.layers.1", D, D, bias="fan_in")
    spec.append(("label_enc.weight", (K + 1, D), "normal"))
    for i in range(cfg["num_decoder_layers"]):
        for part in ("query", "key", "value", "out"):
            linear(f"decoder_layers.{i}.self_attn.{part}", D, D)
        norm(f"decoder_layers.{i}.norm_0")
        msda(f"decoder_layers.{i}.msda")
        norm(f"decoder_layers.{i}.norm_1")
        ffn(f"decoder_layers.{i}.ffn")
    norm("decoder_norm")
    linear("class_head", D, K, "fan_in", "prior")
    box_mlp("box_head")
    return spec


def detector_weights(cfg: dict, seed: int, device) -> dict:
    """The DINO detector's f32 weights from ``seed``: one uniform and one
    normal draw on ``device`` for all of them, sliced and scaled."""
    spec = detector_spec(cfg)
    g = inputs.generator(seed, device, "weights", "dino")
    n_uniform = sum(math.prod(s) for _, s, k in spec
                    if k in ("xavier", "fan_in", "moved"))
    n_normal = sum(math.prod(s) for _, s, k in spec if k == "normal")
    uniform = torch.rand(n_uniform, generator=g, device=device) * 2 - 1
    normal = torch.randn(n_normal, generator=g, device=device)
    H, L, P = cfg["num_heads"], cfg["num_levels"], cfg["num_points"]
    prior = -math.log((1 - 0.01) / 0.01)
    weights, iu, inn, fan_in = {}, 0, 0, {}
    for name, shape, kind in spec:
        n = math.prod(shape)
        layer = name.rsplit(".", 1)[0]
        if name.endswith(".weight") and len(shape) == 2:
            fan_in[layer] = shape[1]
        if kind == "xavier":
            t = uniform[iu:iu + n].view(shape) * math.sqrt(6.0 / sum(shape))
            iu += n
        elif kind in ("fan_in", "moved"):
            scale = inputs.MOVED if kind == "moved" else 1.0
            t = uniform[iu:iu + n].view(shape) * (scale
                                                  / math.sqrt(fan_in[layer]))
            iu += n
        elif kind == "normal":
            t = normal[inn:inn + n].view(shape)
            inn += n
        elif kind in ("zero", "one"):
            t = torch.full(shape, float(kind == "one"), device=device)
        elif kind == "prior":
            t = torch.full(shape, prior, device=device)
        else:  # grid
            t = torch.zeros((H, L, P, 3), device=device)
            t[..., :2] = inputs._grid(H, L, P).to(device)
            t = t.view(shape)
        weights[name] = t.contiguous()
    return weights
