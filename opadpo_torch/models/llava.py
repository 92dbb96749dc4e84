"""LLaVA-1.5 assembly: port of ``opadpo_tpu/models/llava.py``.

CLIP tower -> mm_projector -> LLaMA decoder, with the 576 projected patches
spliced in at each row's ``IMAGE_TOKEN_INDEX``: for output position p and
splice point q,

    p < q          -> text token p
    q <= p < q+P   -> image patch p-q
    p >= q+P       -> text token p-(P-1)

RoPE positions are ``max(cumsum(mask) - 1, 0)`` of the spliced mask.  The
CoPO "attention" method masks patches through ``image_mask``, spliced into
the key mask the same way; SFT labels are spliced too, ``IGNORE_INDEX`` on
the patches.

Visual-token pruning (``LlavaConfig.visual_tokens`` K): only the K
projected patches with the largest f32 sum of squares are kept, in
spatial order, so every downstream length (the splice, the prompt cache,
the scoring sequence) shrinks by 576 - K; the weights are unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from opadpo_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from opadpo_torch.device import resolve_device
from opadpo_torch.models import clip as clip_model
from opadpo_torch.models import llama as llama_model
from opadpo_torch.models import projector as projector_model
from opadpo_torch.models.lora import LoraConfig, init_lora_entry, tree_get
from opadpo_torch.ops import quant
from opadpo_torch.parallel import sharding


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    llama: llama_model.LlamaConfig
    vision: clip_model.ClipVisionConfig
    projector: projector_model.ProjectorConfig
    # training-free visual-token pruning: keep the top K projected patches
    # by feature norm (None, or K >= the patch count: all of them)
    visual_tokens: Optional[int] = None

    @staticmethod
    def llava_7b() -> "LlavaConfig":
        lm = llama_model.LlamaConfig.llava_7b()
        vis = clip_model.ClipVisionConfig()
        return LlavaConfig(lm, vis, projector_model.ProjectorConfig(
            in_dim=vis.hidden_size, out_dim=lm.hidden_size))

    @staticmethod
    def llava_13b() -> "LlavaConfig":
        lm = llama_model.LlamaConfig.llava_13b()
        vis = clip_model.ClipVisionConfig()
        return LlavaConfig(lm, vis, projector_model.ProjectorConfig(
            in_dim=vis.hidden_size, out_dim=lm.hidden_size))

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlavaConfig":
        lm = llama_model.LlamaConfig.tiny(vocab_size)
        vis = clip_model.ClipVisionConfig.tiny()
        return LlavaConfig(lm, vis, projector_model.ProjectorConfig(
            in_dim=vis.hidden_size, out_dim=lm.hidden_size))

    @property
    def num_patches(self) -> int:
        """The patch tokens spliced into the sequence: every consumer
        (splice, cache sizes, samplers, the slot pool) keys off this."""
        if self.visual_tokens:
            return min(self.visual_tokens, self.vision.num_patches)
        return self.vision.num_patches


class Llava(nn.Module):
    def __init__(self, cfg: LlavaConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = clip_model.ClipVisionTower(cfg.vision)
        self.projector = projector_model.Projector(cfg.projector)
        self.llama = llama_model.LlamaModel(cfg.llama)


def empty_model(cfg: LlavaConfig, device="cuda") -> Llava:
    """Uninitialised, frozen model on ``device`` (built on the meta device
    first, so no host memory or init work is spent on the weights)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Llava(cfg)
    return model.to_empty(device=dev).requires_grad_(False)


def _init_(name: str, p: torch.Tensor, generator: torch.Generator) -> None:
    """Fill parameter ``name`` in place: biases 0, norm scales 1, the rest
    N(0, 0.02) drawn from ``generator`` in f32 and cast to p's dtype."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        p.zero_()
    elif "norm" in name or ".ln" in name:
        p.fill_(1.0)
    else:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * 0.02)


@torch.no_grad()
def init_params(cfg: LlavaConfig, generator: torch.Generator,
                device="cuda") -> Llava:
    """Random model as ``opadpo_tpu.models.llava.init_params`` makes it:
    weights and embeddings N(0, 0.02) in the model dtype, norm scales 1 and
    biases 0 in their own dtypes.  Draws come from ``generator``, which must
    live on ``device``; weights are made on the device itself."""
    model = empty_model(cfg, device)
    for name, p in model.named_parameters():
        _init_(name, p, generator)
    return model


@torch.no_grad()
def init_params_quantized(cfg: LlavaConfig, generator: torch.Generator,
                          bits: int = 8, device="cuda",
                          mode: quant.QuantMode = quant.QuantMode(),
                          tp: Optional[tuple] = None) -> Llava:
    """``quant.quantize_params(init_params(cfg, generator, device), bits)``
    without the whole bf16 model ever existing: the parameters are drawn
    in ``init_params``' order, one at a time, and each quantizable weight
    is quantized as soon as it is drawn, so the codes are the same
    (``bits`` 16: no weight is quantized).  ``tp`` ``(rank, n)``: each
    decoder weight and the lm_head are cut to model rank ``rank``'s shard
    of ``n`` as soon as they are drawn (and quantized), so no rank ever
    holds the whole decoder (``parallel/sharding.py``)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Llava(cfg)
    model.requires_grad_(False)
    targets = {id(lin) for _, _, lin in quant.quantizable_linears(model)}
    for name, p in list(model.named_parameters()):
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        t = torch.empty(p.shape, dtype=p.dtype, device=dev)
        _init_(name, t, generator)
        split = None
        if tp is not None and name.startswith("llama.") and attr == "weight":
            split = sharding.split_of(owner_name.rpartition(".")[2])
        if id(owner) in targets and attr == "weight" and bits != 16:
            parent_name, _, child = owner_name.rpartition(".")
            qlin = quant.QuantLinear.from_weight(t, bits, mode=mode)
            if split is not None:
                qlin = sharding.shard_quant(qlin, split, *tp)
            targets.add(id(qlin))
            setattr(model.get_submodule(parent_name), child, qlin)
        elif split is not None:
            t = sharding.shard_weight(t, split, *tp)
            setattr(owner, attr, torch.nn.Parameter(t, requires_grad=False))
            owner.out_features, owner.in_features = t.shape
        elif isinstance(owner, quant.QuantLinear):
            owner.bias = t                # the bias follows its weight
        else:
            setattr(owner, attr, torch.nn.Parameter(t, requires_grad=False))
    return model


def check_prunable(cfg: LlavaConfig, image_key_mask) -> None:
    """Pruning and a CoPO per-patch ``image_key_mask`` (which indexes the
    full patch grid) do not compose: raise before the vision tower runs."""
    if image_key_mask is not None and \
            cfg.num_patches < cfg.vision.num_patches:
        raise ValueError(
            "visual_tokens pruning does not compose with image_key_mask "
            "(CoPO attention masking indexes the full patch grid)")


def prune_patches(proj: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` patches of ``proj`` [B, P, D] with the largest f32 sum of
    squares, in spatial order; ties go to the lower patch index, as
    ``lax.top_k`` breaks them (a stable descending sort)."""
    if k >= proj.shape[1]:
        return proj
    score = proj.float().square().sum(dim=-1)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    idx = torch.sort(order[:, :k], dim=1).values
    return torch.gather(proj, 1, idx[..., None].expand(-1, -1,
                                                       proj.shape[2]))


def encode_images(model: Llava, images: torch.Tensor, lora=None,
                  lora_scaling: float = 1.0, remat: bool = True
                  ) -> torch.Tensor:
    """[B, H, W, 3] -> projected patch features [B, num_patches, D]
    (pruned to ``cfg.visual_tokens`` when set)."""
    feats = model.vision(images, lora=tree_get(lora, "vision"),
                         lora_scaling=lora_scaling, remat=remat)
    proj = model.projector(feats, lora=tree_get(lora, "projector"),
                           lora_scaling=lora_scaling)
    return prune_patches(proj, model.cfg.num_patches)


def splice_positions(input_ids: torch.Tensor) -> torch.Tensor:
    """Index of the (first) image token per row, [B]."""
    return torch.argmax((input_ids == IMAGE_TOKEN_INDEX).to(torch.int32),
                        dim=1)


def _gather_indices(splice_pos: torch.Tensor, text_len: int,
                    num_patches: int):
    """(is_image, text_idx, image_idx), each [B, text_len - 1 + P]."""
    s_out = text_len - 1 + num_patches
    p = torch.arange(s_out, device=splice_pos.device)[None, :]
    q = splice_pos[:, None]
    is_image = (p >= q) & (p < q + num_patches)
    text_idx = torch.clamp(torch.where(p < q, p, p - (num_patches - 1)),
                           0, text_len - 1)
    image_idx = torch.clamp(p - q, 0, num_patches - 1)
    return is_image, text_idx, image_idx


def splice_sequence(text_embeds: torch.Tensor, image_feats: torch.Tensor,
                    text_mask: torch.Tensor, splice_pos: torch.Tensor,
                    image_mask: Optional[torch.Tensor] = None,
                    text_labels: Optional[torch.Tensor] = None):
    """-> (embeds [B, S, D], key_mask [B, S] int), and with ``text_labels``
    [B, L] also the spliced labels [B, S] (``IGNORE_INDEX`` on the
    patches); ``image_mask`` [B, P] marks the valid patches (all of them
    when None)."""
    b, l, d = text_embeds.shape
    p = image_feats.shape[1]
    is_image, text_idx, image_idx = _gather_indices(splice_pos, l, p)
    gath_text = torch.gather(text_embeds, 1,
                             text_idx[..., None].expand(-1, -1, d))
    gath_img = torch.gather(image_feats, 1,
                            image_idx[..., None].expand(-1, -1, d))
    embeds = torch.where(is_image[..., None], gath_img, gath_text)
    tmask = torch.gather(text_mask.to(torch.int64), 1, text_idx)
    if image_mask is None:
        imask = torch.ones_like(tmask)
    else:
        imask = torch.gather(image_mask.to(torch.int64), 1, image_idx)
    key_mask = torch.where(is_image, imask, tmask)
    if text_labels is None:
        return embeds, key_mask
    labels = torch.where(is_image, IGNORE_INDEX,
                         torch.gather(text_labels, 1, text_idx))
    return embeds, key_mask, labels


def spliced_positions(key_mask: torch.Tensor) -> torch.Tensor:
    """RoPE positions of a spliced sequence: max(cumsum(mask) - 1, 0)."""
    return torch.clamp(torch.cumsum(key_mask, dim=1) - 1, min=0)


def init_lora(cfg: LlavaConfig, lora_cfg: LoraConfig,
              generator: torch.Generator,
              include_vision: bool = False) -> dict:
    """The adapter tree: the decoder's seven linears of every layer, and
    with ``include_vision`` (the OPA-SFT recipe's ``tune_vision_tower``)
    also the six linears of each active CLIP block and the projector's
    two, with the JAX package's entry names and widths.  The patch
    embedding has none, so no gradient reaches the images."""
    lora = {"llama": llama_model.init_lora(cfg.llama, lora_cfg, generator)}
    if include_vision:
        d, i = cfg.vision.hidden_size, cfg.vision.intermediate_size
        shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                  "fc1": (d, i), "fc2": (i, d)}
        lora["vision"] = {"layers": [
            {name: init_lora_entry(a, b, lora_cfg, generator)
             for name, (a, b) in shapes.items()}
            for _ in range(cfg.vision.num_active_layers)]}
        p_in, p_out = cfg.projector.in_dim, cfg.projector.out_dim
        lora["projector"] = {
            "fc1": init_lora_entry(p_in, p_out, lora_cfg, generator),
            "fc2": init_lora_entry(p_out, p_out, lora_cfg, generator)}
    return lora


def forward(model: Llava, input_ids: torch.Tensor, text_mask: torch.Tensor,
            images: torch.Tensor, lora=None, lora_scaling: float = 1.0,
            image_key_mask: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None,
            remat: bool = True, return_hidden: bool = False) -> dict:
    """Full-sequence forward (training / scoring) over the spliced sequence
    of length L - 1 + P -> dict(logits [B, S, V] f32 or, with
    ``return_hidden``, hidden [B, S, D]; key_mask [B, S]; labels [B, S],
    the spliced ``labels`` [B, L], or None).  ``remat`` covers the CLIP
    blocks and the decoder's layers."""
    check_prunable(model.cfg, image_key_mask)
    image_feats = encode_images(model, images, lora, lora_scaling, remat)
    text_embeds = llama_model.embed_tokens(model.llama, input_ids)
    embeds, key_mask, *spliced = splice_sequence(
        text_embeds, image_feats.to(text_embeds.dtype), text_mask,
        splice_positions(input_ids), image_mask=image_key_mask,
        text_labels=labels)
    out = llama_model.forward(
        model.llama, embeds, key_mask, spliced_positions(key_mask),
        lora=tree_get(lora, "llama"), lora_scaling=lora_scaling, remat=remat,
        return_hidden=return_hidden)
    return {"hidden" if return_hidden else "logits": out,
            "key_mask": key_mask, "labels": spliced[0] if spliced else None}


def prefill_unrolled(model: Llava, input_ids: torch.Tensor,
                     text_mask: torch.Tensor, images: torch.Tensor,
                     lora=None, lora_scaling: float = 1.0,
                     quantize_kv: bool = False,
                     kv_total_len: Optional[int] = None, kv_bits: int = 8,
                     head=None) -> dict:
    """Prompt pass -> dict(kv_list, last_logits [B, V] f32, key_mask
    [B, Sp], next_position [B]).  With ``quantize_kv`` the prompt KV comes
    back as int8 (``kv_bits`` 8) or packed int4 (4) head-major dicts
    (``llama.quantize_prompt_kv_list``), preallocated at ``kv_total_len``
    positions when given (chunked decode folds into it in place); ``head``
    is a quantized decode head (``llama.quantize_head_for_decode``)."""
    image_feats = encode_images(model, images, lora, lora_scaling)
    text_embeds = llama_model.embed_tokens(model.llama, input_ids)
    embeds, key_mask = splice_sequence(
        text_embeds, image_feats.to(text_embeds.dtype), text_mask,
        splice_positions(input_ids))
    positions = spliced_positions(key_mask)
    logits, kv_list = llama_model.forward_prefill_unrolled(
        model.llama, embeds, key_mask, positions,
        lora=tree_get(lora, "llama"), lora_scaling=lora_scaling, head=head)
    if quantize_kv:
        kv_list = llama_model.quantize_prompt_kv_list(kv_list, kv_total_len,
                                                      kv_bits)
    return {"kv_list": kv_list, "last_logits": logits, "key_mask": key_mask,
            "next_position": positions[:, -1] + 1}


def decode_step_unrolled(model: Llava, token_ids: torch.Tensor,
                         prompt_kv_list: list, prompt_mask: torch.Tensor,
                         suffix_list: list, step: int,
                         positions: torch.Tensor, lora=None,
                         lora_scaling: float = 1.0,
                         sp_used: Optional[int] = None, head=None):
    """One sampled token [B] through the decoder -> (logits [B, V],
    suffix_list); ``head`` as for ``prefill_unrolled``."""
    embeds = llama_model.embed_tokens(model.llama, token_ids[:, None])
    return llama_model.decode_forward_unrolled(
        model.llama, embeds, prompt_kv_list, prompt_mask, suffix_list, step,
        positions, lora=tree_get(lora, "llama"), lora_scaling=lora_scaling,
        sp_used=sp_used, head=head)


def decode_step_multi(model: Llava, token_ids: torch.Tensor,
                      prompt_kv_list: list, prompt_mask: torch.Tensor,
                      suffix_list: list, step: int, positions: torch.Tensor,
                      lora=None, lora_scaling: float = 1.0,
                      sp_used: Optional[int] = None, head=None):
    """Speculative verify: [B, G] tokens (the carry token, then G - 1
    drafts) through the decoder -> (logits [B, G, V], suffix_list)."""
    embeds = llama_model.embed_tokens(model.llama, token_ids)
    return llama_model.decode_forward_multi(
        model.llama, embeds, prompt_kv_list, prompt_mask, suffix_list, step,
        positions, lora=tree_get(lora, "llama"), lora_scaling=lora_scaling,
        sp_used=sp_used, head=head)


def decode_step_multi_pr(model: Llava, token_ids: torch.Tensor,
                         prompt_kv_list: list, prompt_mask: torch.Tensor,
                         raw_list: list, settled_list: list, slot: int,
                         raw_ok: torch.Tensor, w: torch.Tensor,
                         positions: torch.Tensor, lora=None,
                         lora_scaling: float = 1.0,
                         sp_used: Optional[int] = None, head=None):
    """Per-row speculative verify step -> (logits [B, G, V], raw_list)."""
    embeds = llama_model.embed_tokens(model.llama, token_ids)
    return llama_model.decode_forward_multi_pr(
        model.llama, embeds, prompt_kv_list, prompt_mask, raw_list,
        settled_list, slot, raw_ok, w, positions,
        lora=tree_get(lora, "llama"), lora_scaling=lora_scaling,
        sp_used=sp_used, head=head)
