"""Everything a run feeds the program and the reference, made from the
seed on the run's device: the detector's weights, pyramids, targets and
the op's inputs.  The program and the reference get the same tensors; the
program gets nothing else."""

from __future__ import annotations

import hashlib
import math

import torch

from .reference.detr import encoder_points


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for one use of ``seed`` (the weights, a pool, ...):
    the same names give the same seed in every process."""
    text = ":".join([str(int(seed)), *map(str, names)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(seed: int, device, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *names))


# -- the detector's weights --------------------------------------------------

#: the scale, in U(+-1/sqrt(fan_in)), of the weights that the official
#: initialisation zeroes and training moves (``detector_spec``).  Small:
#: at 1.0 the widest served gaps swing from seed to seed as far as those
#: of the fp8 control, and the checks could not tell the two apart.
MOVED = 0.1


def _grid(H: int, L: int, P: int) -> torch.Tensor:
    """The official initial sampling offsets, [H, L, P, 2] in pixels: head
    h looks along the angle 2*pi*h/H, point p at distance p + 1, the
    larger of the two coordinates 1."""
    theta = torch.arange(H, dtype=torch.float64) * (2.0 * math.pi / H)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    steps = torch.arange(1, P + 1, dtype=torch.float64)
    return (grid[:, None, None, :] * steps[None, None, :, None]).expand(
        H, L, P, 2).float()


def detector_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every parameter of the detector, under
    the names of its ``state_dict``.  ``init``: ``xavier``, ``fan_in``
    (U(+-1/sqrt(fan_in)) with the fan of the layer named), ``normal``,
    ``zero``, ``one``, ``grid`` (the sampling offsets' bias), ``prior``
    (the focal prior -log(99)) or ``moved`` (``fan_in`` times
    ``MOVED``).

    The official initialisation zeroes the box heads and the projection
    of a query to its sampling offsets and attention logits; trained
    weights do not, and a step sees them at zero only once.  Those weights
    are drawn as ``moved`` instead, so that a query's points and weights
    and every box depend on the input, as they do in a trained model."""
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

    spec.append(("level_embedding", (L, D), "normal"))
    for lvl, c in enumerate(cfg["in_channels"]):
        linear(f"input_proj.{lvl}", c, D)
    for i in range(cfg["num_encoder_layers"]):
        msda(f"encoder_layers.{i}.msda")
        norm(f"encoder_layers.{i}.norm_0")
        ffn(f"encoder_layers.{i}.ffn")
    spec.append(("query_embedding", (Q, D), "normal"))
    spec.append(("reference_box_logits", (Q, 4), "normal"))
    for i in range(cfg["num_decoder_layers"]):
        for part in ("query", "key", "value", "out"):
            linear(f"decoder_layers.{i}.self_attn.{part}", D, D)
        norm(f"decoder_layers.{i}.norm_0")
        msda(f"decoder_layers.{i}.msda")
        norm(f"decoder_layers.{i}.norm_1")
        ffn(f"decoder_layers.{i}.ffn")
    refine = cfg["num_decoder_layers"] - 1 if cfg["with_box_refinement"] else 0
    for i in range(refine):
        linear(f"box_refine.{i}", D, 4, "moved")
    for i in range(refine):
        linear(f"aux_class.{i}", D, K, "fan_in", "prior")
    linear("class_head", D, K, "fan_in", "prior")
    linear("box_head", D, 4, "moved")
    return spec


def detector_weights(cfg: dict, seed: int, device) -> dict:
    """The detector's f32 weights from ``seed``, as the official
    ``_reset_parameters`` draws them but for the weights that training
    moves off zero (``detector_spec``): one uniform and
    one normal draw on ``device`` for all of them, sliced and scaled."""
    spec = detector_spec(cfg)
    g = generator(seed, device, "weights")
    n_uniform = sum(math.prod(s) for _, s, k in spec
                    if k in ("xavier", "fan_in", "moved"))
    n_normal = sum(math.prod(s) for _, s, k in spec if k == "normal")
    uniform = torch.rand(n_uniform, generator=g, device=device) * 2 - 1
    normal = torch.randn(n_normal, generator=g, device=device)
    H, L, P = cfg["num_heads"], cfg["num_levels"], cfg["num_points"]
    prior = -math.log((1 - 0.01) / 0.01)
    weights, iu, inn = {}, 0, 0
    fan_in = {}
    for name, shape, kind in spec:
        n = math.prod(shape)
        layer = name.rsplit(".", 1)[0]
        if name.endswith(".weight") and len(shape) == 2:
            fan_in[layer] = shape[1]
        if kind == "xavier":
            t = uniform[iu:iu + n].view(shape) * math.sqrt(6.0 / sum(shape))
            iu += n
        elif kind in ("fan_in", "moved"):
            scale = MOVED if kind == "moved" else 1.0
            t = uniform[iu:iu + n].view(shape) * (scale
                                                  / math.sqrt(fan_in[layer]))
            iu += n
        elif kind == "normal":
            t = normal[inn:inn + n].view(shape)
            inn += n
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        elif kind == "one":
            t = torch.ones(shape, device=device)
        elif kind == "prior":
            t = torch.full(shape, prior, device=device)
        elif kind == "grid":
            t = torch.zeros((H, L, P, 3), device=device)
            t[..., :2] = _grid(H, L, P).to(device)
            t = t.view(shape)
        else:
            raise ValueError(f"unknown init {kind!r} of {name}")
        weights[name] = t.contiguous()
    return weights


# -- the detector's inputs ---------------------------------------------------

def level_shapes(cfg: dict, hw) -> tuple:
    """The pyramid of an input of ``hw`` pixels: ``ceil(size / stride)``."""
    return tuple((-(-int(hw[0]) // s), -(-int(hw[1]) // s))
                 for s in cfg["strides"])


def pyramid(cfg: dict, hw, batch: int, g: torch.Generator, device) -> list:
    """Backbone features of a batch at ``hw``: per level ``[B, h, w, C]``,
    N(0, 1), f32."""
    return [torch.randn((batch, h, w, c), generator=g, device=device)
            for (h, w), c in zip(level_shapes(cfg, hw), cfg["in_channels"])]


def targets(cfg: dict, traffic: dict, g: torch.Generator, device) -> dict:
    """Detection targets of a batch: ``target_slots`` slots an image, a
    seeded ``real_targets`` range of them real; labels uniform over the
    classes, cxcywh boxes with w and h uniform in ``box_wh`` inside the
    image."""
    B, M = traffic["batch"], traffic["target_slots"]
    lo, hi = traffic["box_wh"]
    wh = lo + (hi - lo) * torch.rand((B, M, 2), generator=g, device=device)
    centers = wh / 2 + torch.rand((B, M, 2), generator=g,
                                  device=device) * (1 - wh)
    first, last = traffic["real_targets"]
    real = torch.randint(first, last + 1, (B, 1), generator=g, device=device)
    mask = (torch.arange(M, device=device)[None] < real).float()
    labels = torch.randint(0, cfg["num_classes"], (B, M), generator=g,
                           device=device)
    return {"labels": labels, "boxes": torch.cat([centers, wh], -1),
            "mask": mask}


# -- the op's inputs ---------------------------------------------------------

def op_inputs(cfg: dict, traffic: dict, g: torch.Generator, device) -> dict:
    """One input set of the op as the encoder calls it: every pixel a
    query, its points the official offset grid around its centre plus
    seeded jitter, divided by the sampled level's (width, height)."""
    H, C, L, P = (cfg["num_heads"], cfg["head_dim"], cfg["num_levels"],
                  cfg["num_points"])
    B = traffic["batch"]
    shapes = level_shapes(cfg, traffic["size"])
    I = sum(h * w for h, w in shapes)  # noqa: E741
    img = torch.randn((B, I, H, C), generator=g, device=device)
    ref = encoder_points(shapes, device)  # [I, 2]
    jitter = torch.randn((B, I, H, L, P, 2), generator=g, device=device)
    offsets = _grid(H, L, P).to(device) + traffic["jitter_px"] * jitter
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device=device)  # [L, 2] as (x, y)
    pts = ref[None, :, None, None, None, :] + offsets / wh[:, None, :]
    logits = torch.randn((B, I, H, L * P), generator=g, device=device)
    wts = torch.softmax(logits, -1).view(B, I, H, L, P)
    og = torch.randn((B, I, H, C), generator=g, device=device)
    return {"img": img, "shapes": shapes, "pts": pts.contiguous(),
            "wts": wts.contiguous(), "og": og}
