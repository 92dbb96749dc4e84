"""Checkpoint interop: HF / original-LLaVA weights and PEFT adapters into
the port's modules, and back out.  Port of ``opadpo_tpu/models/loader.py``.

The port fills an ``empty_model`` directly from the state dict.  Torch's
``Linear`` keeps HF's ``[out, in]`` layout and the port keeps one module
per layer, so nothing is transposed or stacked: each tensor crosses to the
device in its file dtype and is cast there into its slot (norms f32,
everything else the model dtype, as the JAX ``_cast`` does).  The CLIP
convolution ``[D, 3, p, p]`` flattens to ``patch_embed.weight [D, 3 p p]``
in (c, ph, pw) order, the order ``clip.patchify`` makes.  Only the vision
tower's first ``num_active_layers`` blocks are read: the checkpoint's last
block and ``post_layernorm`` sit above the selected layer.

Layouts read: the original LLaVA one (``model.layers.*``,
``model.mm_projector.{0,2}.*``, the vision tower in the directory under
``model.vision_tower.vision_tower.vision_model.`` or in a separate CLIP
directory), and both llava-hf ones (transformers >= 4.52 and the legacy
``language_model.model.*`` names).  Files are safetensors, read by the
port's own reader (``safetensors_io``), or torch ``*.bin`` shards.

A PEFT adapter keeps PEFT's own layout here too (``lora_A [r, in]``,
``lora_B [out, r]``, as ``models/lora.py`` stores its factors), so reading
and writing one only renames.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Optional

import torch

from opadpo_torch.device import resolve_device
from opadpo_torch.models import safetensors_io
from opadpo_torch.models.llava import Llava, LlavaConfig, empty_model

VISION_IN_DIR = "model.vision_tower.vision_tower.vision_model."


def load_state_dict(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """Every weight of a checkpoint directory as CPU tensors in their file
    dtypes: its safetensors files when it has any, else its torch ``*.bin``
    shards (memory-mapped; ``*arguments*`` files such as
    ``training_arguments.bin`` are skipped)."""
    entries = sorted(os.listdir(checkpoint_dir))
    if any(f.endswith(".safetensors") for f in entries):
        return safetensors_io.load_dir(checkpoint_dir)
    state: Dict[str, torch.Tensor] = {}
    for f in entries:
        if f.endswith(".bin") and "arguments" not in f:
            state.update(torch.load(os.path.join(checkpoint_dir, f),
                                    map_location="cpu", weights_only=True,
                                    mmap=True))
    return state


@torch.no_grad()
def _put(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` (file dtype, host) into the slot ``dst``: moved to dst's
    device as it is, then cast there."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} for a "
                         f"{tuple(dst.shape)} slot")
    dst.copy_(src.to(dst.device))


_LLAMA_LINEARS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                  "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
                  "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                  "w_down": "mlp.down_proj"}
_LLAMA_NORMS = {"attn_norm": "input_layernorm",
                "mlp_norm": "post_attention_layernorm"}
_CLIP_LINEARS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                 "wv": "self_attn.v_proj", "wo": "self_attn.out_proj",
                 "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
_CLIP_NORMS = {"ln1": "layer_norm1", "ln2": "layer_norm2"}


def _llama_names(llama, prefix: str, head: str = "lm_head.weight"):
    """(HF name, slot) of every decoder tensor."""
    out = [(prefix + "embed_tokens.weight", llama.embed),
           (prefix + "norm.weight", llama.final_norm),
           (head, llama.lm_head.weight)]
    for i, layer in enumerate(llama.layers):
        lp = f"{prefix}layers.{i}."
        out += [(lp + hf + ".weight", getattr(layer, ours))
                for ours, hf in _LLAMA_NORMS.items()]
        out += [(lp + hf + ".weight", getattr(layer, ours).weight)
                for ours, hf in _LLAMA_LINEARS.items()]
    return out


def _clip_names(vision, prefix: str):
    """(HF name, slot) of every tensor of the vision tower's active
    layers; the patch embedding's slot is the flattened convolution."""
    e = prefix + "embeddings."
    out = [(e + "class_embedding", vision.class_embed),
           (e + "position_embedding.weight", vision.pos_embed),
           (prefix + "pre_layrnorm.weight", vision.pre_norm.weight),
           (prefix + "pre_layrnorm.bias", vision.pre_norm.bias)]
    for i, blk in enumerate(vision.layers):
        lp = f"{prefix}encoder.layers.{i}."
        for ours, hf in {**_CLIP_NORMS, **_CLIP_LINEARS}.items():
            mod = getattr(blk, ours)
            out += [(f"{lp}{hf}.weight", mod.weight),
                    (f"{lp}{hf}.bias", mod.bias)]
    return out


def llama_params_from_state(llama, state: Dict[str, torch.Tensor],
                            prefix: str = "model.",
                            head: str = "lm_head.weight", put=_put) -> None:
    """Fill a ``LlamaModel`` from HF ``LlamaForCausalLM`` names (``put``:
    how a tensor goes into its slot)."""
    for name, slot in _llama_names(llama, prefix, head):
        put(slot, state[name])


def clip_params_from_state(vision, state: Dict[str, torch.Tensor],
                           prefix: str = "vision_model.") -> None:
    """Fill a ``ClipVisionTower`` from HF ``CLIPVisionModel`` names: its
    active layers only."""
    conv = state[prefix + "embeddings.patch_embedding.weight"]
    _put(vision.patch_embed.weight, conv.reshape(conv.shape[0], -1))
    for name, slot in _clip_names(vision, prefix):
        _put(slot, state[name])


def projector_params_from_state(projector, state: Dict[str, torch.Tensor],
                                prefix: str = "model.mm_projector.",
                                names=("0", "2")) -> None:
    """Fill the mlp2x_gelu projector (``names``: its two linears)."""
    for mod, n in zip((projector.fc1, projector.fc2), names):
        _put(mod.weight, state[f"{prefix}{n}.weight"])
        _put(mod.bias, state[f"{prefix}{n}.bias"])


def llava_params_from_hf_state(model: Llava,
                               state: Dict[str, torch.Tensor],
                               put=_put) -> None:
    """Fill a ``Llava`` from HF ``LlavaForConditionalGeneration`` names,
    either llava-hf layout: transformers >= 4.52 (``model.language_model.*``,
    ``model.vision_tower.*``, ``model.multi_modal_projector.*``, a top-level
    ``lm_head.weight``) or the legacy one (``language_model.model.*``
    etc.)."""
    if any(k.startswith("language_model.model.") for k in state):
        def remap(k: str) -> str:
            if k == "language_model.lm_head.weight":
                return "lm_head.weight"
            head = "language_model.model."
            if k.startswith(head):
                return "model.language_model." + k[len(head):]
            if k.startswith(("vision_tower.", "multi_modal_projector.")):
                return "model." + k
            return k
        state = {remap(k): v for k, v in state.items()}
    llama_params_from_state(model.llama, state,
                            prefix="model.language_model.", put=put)
    projector_params_from_state(model.projector, state,
                                prefix="model.multi_modal_projector.",
                                names=("linear_1", "linear_2"))
    clip_params_from_state(model.vision, state,
                           prefix="model.vision_tower.vision_model.")


@torch.no_grad()
def resize_token_embeddings_with_mean(model: Llava, new_vocab: int) -> Llava:
    """Grow the embedding and the lm_head to ``new_vocab`` rows, in place,
    the new rows the f32 mean of the existing ones in the model dtype (the
    reference's patched ``resize_token_embeddings_with_mean``); the
    configuration follows.  A smaller ``new_vocab`` changes nothing."""
    llama = model.llama
    old = llama.embed.shape[0]
    if new_vocab <= old:
        return model
    n_new = new_vocab - old

    def grow(w: torch.Tensor) -> torch.Tensor:
        mean = w.float().mean(dim=0, keepdim=True).to(w.dtype)
        return torch.cat([w, mean.expand(n_new, -1)], dim=0)

    llama.embed = torch.nn.Parameter(grow(llama.embed), requires_grad=False)
    head = torch.nn.Linear(llama.lm_head.in_features, new_vocab, bias=False,
                           device=llama.embed.device,
                           dtype=llama.lm_head.weight.dtype)
    head.weight = torch.nn.Parameter(grow(llama.lm_head.weight),
                                     requires_grad=False)
    llama.lm_head = head
    llama.cfg = dataclasses.replace(llama.cfg, vocab_size=new_vocab)
    model.cfg = dataclasses.replace(model.cfg, llama=llama.cfg)
    return model


def _model_deferring_linears(cfg: LlavaConfig, dev: torch.device):
    """An empty model on ``dev`` whose decoder block linears and lm_head
    stay on the meta device, and ``{id(weight): (owner, name)}`` of
    those."""
    with torch.device("meta"):
        model = Llava(cfg)
    model.requires_grad_(False)
    lm = model.llama
    deferred = {id(lm.lm_head.weight): (lm, "lm_head")}
    for layer in lm.layers:
        for name in _LLAMA_LINEARS:
            deferred[id(getattr(layer, name).weight)] = (layer, name)
    skip = {id(getattr(owner, name)) for owner, name in deferred.values()}
    for mod in model.modules():
        if id(mod) not in skip:
            mod.to_empty(device=dev, recurse=False)
    return model, deferred


def load_llava_checkpoint(model_dir: str, cfg: LlavaConfig,
                          vision_dir: Optional[str] = None,
                          device="cuda", linear=None) -> Llava:
    """A ``Llava`` on ``device`` from a checkpoint directory: a llava-hf
    one, or an original-LLaVA one whose vision tower is in the directory
    (``model.vision_tower.vision_tower.vision_model.*``) or in the CLIP
    directory ``vision_dir`` (the ``image_checkpoint`` config group).

    ``linear(owner, name, weight)``: the decoder's block linears and its
    lm_head are not made on the device; each weight is handed over as it
    is read (on the host, in its file dtype, memory-mapped) to ``linear``,
    which puts a module of its own at ``owner.<name>`` (the meta-device
    module there gives the dtype), one at a time (a rank's quantized
    shard)."""
    dev = resolve_device(device)
    if linear is None:
        model, put = empty_model(cfg, dev), _put
    else:
        model, deferred = _model_deferring_linears(cfg, dev)

        def put(dst, src):
            if id(dst) not in deferred:
                return _put(dst, src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} for a "
                                 f"{tuple(dst.shape)} slot")
            linear(*deferred[id(dst)], src)
    state = load_state_dict(model_dir)
    if any(k.startswith(("model.language_model.", "language_model.model."))
           for k in state):
        llava_params_from_hf_state(model, state, put)
        return model
    llama_params_from_state(model.llama, state, put=put)
    if not any(k.startswith("model.mm_projector.") for k in state):
        raise KeyError("mm_projector weights not found in checkpoint")
    projector_params_from_state(model.projector, state)
    if any(k.startswith(VISION_IN_DIR) for k in state):
        clip_params_from_state(model.vision, state, prefix=VISION_IN_DIR)
    elif vision_dir is not None:
        del state
        clip_params_from_state(model.vision, load_state_dict(vision_dir))
    else:
        raise KeyError("vision tower weights not found and no vision_dir")
    return model


# ---------------------------------------------------------------------------
# Writing checkpoints (export, the tests and the smoke's disk path)
# ---------------------------------------------------------------------------

def llava_state_dict(model: Llava, vision_in_dir: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """The model's tensors under the original-LLaVA names (the module's own
    tensors, not copies); with ``vision_in_dir`` the vision tower's active
    layers too, under ``model.vision_tower.vision_tower.vision_model.``."""
    out = {name: t for name, t in _llama_names(model.llama, "model.")}
    for mod, n in ((model.projector.fc1, "0"), (model.projector.fc2, "2")):
        out[f"model.mm_projector.{n}.weight"] = mod.weight
        out[f"model.mm_projector.{n}.bias"] = mod.bias
    if vision_in_dir:
        out.update(clip_state_dict(model.vision, VISION_IN_DIR))
    return out


def clip_state_dict(vision, prefix: str = "vision_model."
                    ) -> Dict[str, torch.Tensor]:
    """The vision tower's active layers under HF ``CLIPVisionModel``
    names, the patch embedding as the ``[D, 3, p, p]`` convolution."""
    p = vision.cfg.patch_size
    w = vision.patch_embed.weight
    out = {prefix + "embeddings.patch_embedding.weight":
           w.reshape(w.shape[0], 3, p, p)}
    out.update(dict(_clip_names(vision, prefix)))
    return out


def save_llava_checkpoint(model: Llava, out_dir: str, num_shards: int = 2,
                          vision_in_dir: bool = False) -> list:
    """Write the model in the original-LLaVA layout users download:
    ``pytorch_model-0000k-of-0000n.bin`` shards (tensors in the model's
    dtypes, split by bytes in name order), ``pytorch_model.bin.index.json``
    and ``config.json`` (what ``pipeline.runtime.llava_config_from_hf``
    reads back).  Each shard's tensors are copied to the host, saved and
    released before the next -> the shard file names."""
    state = llava_state_dict(model, vision_in_dir)
    names = list(state)
    total = sum(t.numel() * t.element_size() for t in state.values())
    per = -(-total // num_shards)
    groups, size = [[]], 0
    for n in names:
        nbytes = state[n].numel() * state[n].element_size()
        if groups[-1] and size + nbytes > per and len(groups) < num_shards:
            groups.append([])
            size = 0
        groups[-1].append(n)
        size += nbytes
    os.makedirs(out_dir, exist_ok=True)
    files = [f"pytorch_model-{i + 1:05d}-of-{len(groups):05d}.bin"
             for i in range(len(groups))]
    weight_map = {}
    for fname, group in zip(files, groups):
        torch.save({n: state[n].detach().cpu().clone() for n in group},
                   os.path.join(out_dir, fname))
        weight_map.update(dict.fromkeys(group, fname))
    with open(os.path.join(out_dir, "pytorch_model.bin.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    lm, vis = model.cfg.llama, model.cfg.vision
    config = {"architectures": ["LlavaLlamaForCausalLM"],
              "model_type": "llava", "vocab_size": lm.vocab_size,
              "hidden_size": lm.hidden_size,
              "intermediate_size": lm.intermediate_size,
              "num_hidden_layers": lm.num_layers,
              "num_attention_heads": lm.num_heads,
              "num_key_value_heads": lm.num_kv_heads,
              "max_position_embeddings": lm.max_position_embeddings,
              "rope_theta": lm.rope_base, "rms_norm_eps": lm.rms_norm_eps,
              "mm_vision_select_layer": vis.select_layer,
              "mm_projector_type": "mlp2x_gelu",
              "mm_hidden_size": vis.hidden_size,
              "torch_dtype": str(lm.dtype).replace("torch.", "")}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return files


# ---------------------------------------------------------------------------
# PEFT adapter interop (reference adapter_model dirs)
# ---------------------------------------------------------------------------

_PEFT_NAME_MAP = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}
_PEFT_INV_MAP = {v: k for k, v in _PEFT_NAME_MAP.items()}

_PEFT_LAYER_RE = re.compile(
    r"model\.layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight")


def lora_from_peft_state(state: Dict[str, torch.Tensor], llama_cfg,
                         dtype: torch.dtype = torch.bfloat16,
                         device="cuda") -> dict:
    """PEFT ``adapter_model`` tensors -> the port's adapter tree
    ``{"llama": {"layers": [{name: {"a": [r, in], "b": [out, r]}}]}}`` on
    ``device`` in ``dtype`` (cast there).  Only the decoder's seven
    projections are read, as in the JAX package."""
    dev = resolve_device(device)
    layers = [{} for _ in range(llama_cfg.num_layers)]
    for key, val in state.items():
        m = _PEFT_LAYER_RE.search(key)
        if not m or m.group(2) not in _PEFT_NAME_MAP:
            continue
        entry = layers[int(m.group(1))].setdefault(
            _PEFT_NAME_MAP[m.group(2)], {})
        entry[m.group(3).lower()] = val.to(dev).to(dtype)
    return {"llama": {"layers": layers}}


def lora_to_peft_state(lora: dict, base_prefix: str =
                       "base_model.model.model.layers"
                       ) -> Dict[str, torch.Tensor]:
    """The adapter tree's decoder part -> PEFT state-dict names, as f32 CPU
    tensors (so the reference's eval scripts can load trained adapters)."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(lora.get("llama", {}).get("layers", [])):
        for name, ab in layer.items():
            group = "self_attn" if name in ("wq", "wk", "wv", "wo") else "mlp"
            stem = f"{base_prefix}.{i}.{group}.{_PEFT_INV_MAP[name]}"
            for k, hf in (("a", "lora_A"), ("b", "lora_B")):
                out[f"{stem}.{hf}.weight"] = \
                    ab[k].detach().to("cpu", torch.float32).contiguous()
    return out


def save_peft_adapter(lora: dict, out_dir: str, lora_cfg,
                      base_model_name: str = "llava-v1.5") -> None:
    """Write ``adapter_model.bin`` + ``adapter_config.json`` (the PEFT
    directory contract, the JAX package's keys)."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save(lora_to_peft_state(lora),
               os.path.join(out_dir, "adapter_model.bin"))
    config = {
        "base_model_name_or_path": base_model_name,
        "peft_type": "LORA",
        "r": lora_cfg.rank,
        "lora_alpha": lora_cfg.alpha,
        "lora_dropout": 0.0,
        "target_modules": sorted(_PEFT_INV_MAP.values()),
        "task_type": "CAUSAL_LM",
    }
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump(config, f, indent=2)


def load_peft_adapter(adapter_dir: str, llama_cfg,
                      dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> dict:
    return lora_from_peft_state(load_state_dict(adapter_dir), llama_cfg,
                                dtype, device)


def adapter_scaling(adapter_dir: str) -> float:
    """``lora_alpha / r`` of a PEFT directory's ``adapter_config.json``."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    return acfg["lora_alpha"] / acfg["r"]
