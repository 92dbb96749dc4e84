"""The system under test, assembled from a configuration file: the port's
LLaVA (``opadpo_torch``) filled through its own loading path from the
benchmark's weights, quantized by the port where the configuration says so,
and the adapter handed over in the port's tree layout.  The only module of
the harness besides the traffic modules that imports the port."""

from __future__ import annotations

from opadpo_torch.models import clip as clip_model
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import llava
from opadpo_torch.models import projector as projector_model
from opadpo_torch.models.loader import llava_params_from_hf_state
from opadpo_torch.ops import quant


def port_config(cfg: dict) -> llava.LlavaConfig:
    d = cfg["hidden_size"]
    lm = llama_model.LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=d,
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // cfg["num_attention_heads"],
        max_position_embeddings=cfg["max_position_embeddings"],
        rope_base=float(cfg["rope_theta"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]))
    v = cfg["vision"]
    vis = clip_model.ClipVisionConfig(
        image_size=v["image_size"], patch_size=v["patch_size"],
        hidden_size=v["hidden_size"],
        intermediate_size=v["intermediate_size"],
        num_heads=v["num_attention_heads"],
        num_layers=v["num_hidden_layers"],
        select_layer=v["mm_vision_select_layer"],
        layer_norm_eps=float(v["layer_norm_eps"]))
    p = cfg["projector"]
    return llava.LlavaConfig(lm, vis, projector_model.ProjectorConfig(
        in_dim=p["in_features"], out_dim=p["out_features"]))


def quant_mode(precision: dict) -> quant.QuantMode:
    if precision["bits"] == 8 and precision["act_bits"] == 8:
        return quant.QuantMode(act_bits=8,
                               bwd_int8=bool(precision["act_bwd_int8"]))
    return quant.QuantMode()


def build_model(cfg: dict, state: dict, device,
                precision: dict) -> llava.Llava:
    """The port's model on ``device`` from the llava-hf ``state``; an int8
    or int4 base is made by the port's own ``quantize_params``."""
    model = llava.empty_model(port_config(cfg), device)
    llava_params_from_hf_state(model, state)
    if precision["bits"] != 16:
        quant.quantize_params(model, precision["bits"], quant_mode(precision))
    return model


def _copy(group: dict) -> dict:
    return {name: {k: t.detach().clone() for k, t in entry.items()}
            for name, entry in group.items()}


def lora_tree(layers: list, vision=None) -> dict:
    """The benchmark's adapter (per-layer entries of the decoder, and
    ``vision`` = (blocks, projector) where the recipe tunes the vision
    tower) as the port's tree, each leaf a fresh copy."""
    tree = {"llama": {"layers": [_copy(layer) for layer in layers]}}
    if vision is not None:
        blocks, proj = vision
        tree["vision"] = {"layers": [_copy(b) for b in blocks]}
        tree["projector"] = _copy(proj)
    return tree


def leaf_name(path: str) -> str:
    """The port's leaf path ``/llama/layers/3/wq/a`` -> ``layers.3.wq.a``,
    the harness's own leaf names."""
    parts = path.strip("/").split("/")
    return ".".join(parts[1:] if parts[0] == "llama" else parts)
