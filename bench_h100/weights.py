"""The model's weights and the adapter's starting point, drawn from the seed
on the device.

Both sides of a run take them from here: the program through its own
loading path (the llava-hf names of ``names``), the plain reference
directly.  Every random tensor is a view into one flat bf16 buffer filled
by a few large ``randn`` calls of a generator on the device, so the same
seed gives the same weights on both sides and set-up stays short.

- weights N(0, 0.02); norm scales 1 + N(0, 0.02); biases N(0, 0.02);
- adapter A Kaiming-uniform in +-sqrt(3 / in) (PEFT's init), adapter B
  N(0, ``lora_b_std``), both in the configuration's adapter dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28          # elements per randn call
LLAMA_LINEARS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                 "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
                 "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                 "w_down": "mlp.down_proj"}
CLIP_LINEARS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                "wv": "self_attn.v_proj", "wo": "self_attn.out_proj",
                "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
LM = "model.language_model."
VT = "model.vision_tower.vision_model."
PJ = "model.multi_modal_projector."


def mix(*parts: int) -> int:
    """A generator seed from whole numbers (a run's seed, a step, a
    salt), below 2**63."""
    h = 1469598103934665603
    for p in parts:
        h = ((h ^ (int(p) & (2 ** 64 - 1))) * 1099511628211) % (2 ** 64)
    return h % (2 ** 63)


def active_vision_layers(cfg: dict) -> int:
    v = cfg["vision"]
    return v["num_hidden_layers"] + v["mm_vision_select_layer"] + 1


def linear_shapes(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """(in, out) of the decoder's seven block linears."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    return {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv), "wo": (nq, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def names(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(llava-hf name, shape, kind) of every tensor, in draw order; kind is
    "w", "norm" or "bias"."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    vis = cfg["vision"]
    vd, vi, p = vis["hidden_size"], vis["intermediate_size"], \
        vis["patch_size"]
    n_patch = (vis["image_size"] // p) ** 2
    shapes = linear_shapes(cfg)
    out = [(LM + "embed_tokens.weight", (v, d), "w"),
           (LM + "norm.weight", (d,), "norm"),
           ("lm_head.weight", (v, d), "w")]
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{LM}layers.{i}."
        out += [(lp + "input_layernorm.weight", (d,), "norm"),
                (lp + "post_attention_layernorm.weight", (d,), "norm")]
        out += [(f"{lp}{hf}.weight", (shapes[n][1], shapes[n][0]), "w")
                for n, hf in LLAMA_LINEARS.items()]
    e = VT + "embeddings."
    out += [(e + "patch_embedding.weight", (vd, 3, p, p), "w"),
            (e + "class_embedding", (vd,), "w"),
            (e + "position_embedding.weight", (n_patch + 1, vd), "w"),
            (VT + "pre_layrnorm.weight", (vd,), "norm"),
            (VT + "pre_layrnorm.bias", (vd,), "bias")]
    clip_shapes = {"wq": (vd, vd), "wk": (vd, vd), "wv": (vd, vd),
                   "wo": (vd, vd), "fc1": (vd, vi), "fc2": (vi, vd)}
    for i in range(active_vision_layers(cfg)):
        lp = f"{VT}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            out += [(f"{lp}{ln}.weight", (vd,), "norm"),
                    (f"{lp}{ln}.bias", (vd,), "bias")]
        for ours, hf in CLIP_LINEARS.items():
            k, o = clip_shapes[ours]
            out += [(f"{lp}{hf}.weight", (o, k), "w"),
                    (f"{lp}{hf}.bias", (o,), "bias")]
    pin, pout = cfg["projector"]["in_features"], \
        cfg["projector"]["out_features"]
    out += [(PJ + "linear_1.weight", (pout, pin), "w"),
            (PJ + "linear_1.bias", (pout,), "bias"),
            (PJ + "linear_2.weight", (pout, pout), "w"),
            (PJ + "linear_2.bias", (pout,), "bias")]
    return out


def _flat_normal(n: int, seed: int, device, dtype) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(n, dtype=dtype, device=device)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        buf[s:s + m] = torch.randn(m, generator=gen, device=device,
                                   dtype=dtype)
    return buf


@torch.no_grad()
def draw_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the model in bf16 on ``device``, under llava-hf
    names: views into one buffer."""
    spec = names(cfg)
    total = sum(math.prod(s) for _, s, _ in spec)
    buf = _flat_normal(total, mix(seed, 1), device, torch.bfloat16)
    buf.mul_(0.02)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        if kind == "norm":
            t.add_(1.0)
        out[name] = t
        off += n
    return out


def _draw_entries(cfg: dict, shapes: Dict[str, Tuple[int, int]],
                  count: int, seed: int, device) -> List[Dict[str, dict]]:
    """``count`` groups of adapter entries ``{name: {"a": [r, in], "b":
    [out, r]}}`` over the linears of ``shapes`` ((in, out) each)."""
    t = cfg["training"]
    r = t["lora_r"]
    dtype = getattr(torch, t.get("lora_dtype", "float32"))
    per_a = sum(r * i for i, _ in shapes.values())
    per_b = sum(r * o for _, o in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    a_all = torch.rand(count * per_a, generator=gen, device=device,
                       dtype=torch.float32)
    b_all = torch.randn(count * per_b, generator=gen, device=device,
                        dtype=torch.float32) * t["lora_b_std"]
    groups, oa, ob = [], 0, 0
    for _ in range(count):
        group = {}
        for name, (i, o) in shapes.items():
            bound = math.sqrt(3.0 / i)
            a = (a_all[oa:oa + r * i].view(r, i) * 2.0 - 1.0) * bound
            b = b_all[ob:ob + o * r].view(o, r)
            group[name] = {"a": a.to(dtype), "b": b.to(dtype).clone()}
            oa += r * i
            ob += o * r
        groups.append(group)
    return groups


@torch.no_grad()
def draw_lora(cfg: dict, seed: int, device) -> List[Dict[str, dict]]:
    """The adapter over the decoder's seven linears of every layer: per
    layer ``{name: {"a": [r, in], "b": [out, r]}}``."""
    return _draw_entries(cfg, linear_shapes(cfg), cfg["num_hidden_layers"],
                         mix(seed, 2), device)


@torch.no_grad()
def draw_vision_lora(cfg: dict, seed: int, device):
    """The adapter of the OPA-SFT recipe's vision tower (the six linears of
    each active CLIP block) and projector (its two linears) -> (blocks,
    projector)."""
    v = cfg["vision"]
    vd, vi = v["hidden_size"], v["intermediate_size"]
    clip = {"wq": (vd, vd), "wk": (vd, vd), "wv": (vd, vd), "wo": (vd, vd),
            "fc1": (vd, vi), "fc2": (vi, vd)}
    blocks = _draw_entries(cfg, clip, active_vision_layers(cfg),
                           mix(seed, 5), device)
    p = cfg["projector"]
    pin, pout = p["in_features"], p["out_features"]
    proj = _draw_entries(cfg, {"fc1": (pin, pout), "fc2": (pout, pout)}, 1,
                         mix(seed, 6), device)[0]
    return blocks, proj
