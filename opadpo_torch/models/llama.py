"""LLaMA / Vicuna decoder: port of ``opadpo_tpu/models/llama.py``.

- ``forward`` and ``forward_shared_prefix``: the training / scoring
  passes over whole sequences, each layer under
  ``torch.utils.checkpoint`` when ``remat`` (the JAX package's
  ``jax.checkpoint`` on its layer scan), attention through the fused
  RoPE + head-layout + flash composites of ``ops/attention``.
- ``forward_prefill_unrolled``: the prompt pass, returning the last
  position's logits and every layer's (k, v), with causal attention on the
  flash kernel (``ops/attention``).
- ``quantize_prompt_kv`` / ``quantize_prompt_kv_int4``: per-(b, s, h)
  symmetric int8 / packed int4, head-major, padded with zero scales to a
  128 / 256-multiple or preallocated at a chunked decode's final length;
  ``fold_suffix_into_prompt_kv`` writes a quantized suffix into that cache
  in place.
- ``decode_forward_unrolled`` / ``decode_forward_multi``: one token (or a
  speculative verify group of G) through every layer against the prompt
  KV (bf16, or int8 / int4 through the decode-attention kernels) and a
  small bf16 suffix buffer that the step writes in place, merged by
  logsumexp; ``decode_forward_multi_pr`` the per-row verify over raw and
  settled suffix regions.

Projections run in the model dtype and widen to f32 for the LoRA sum; the
decode head returns f32 logits.

Under tensor parallelism (``parallel/sharding.shard_module``: ``tp`` set
on the model and its layers, ``cfg`` made local) each rank runs its heads
and its slice of the MLP and of the vocabulary, Megatron-style: the input
of the column-parallel ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` enters
the model region once per block (``comm.copy_to_model``), the row-parallel
``wo`` and ``w_down`` return partial sums that one ``all_reduce`` adds
(their LoRA delta added before it, in f32), and the logits of the split
lm_head are gathered over the vocabulary.  A replicated LoRA factor whose
gradient each rank holds only part of (every ``a``, and ``b`` of a
row-parallel weight) enters the region too, so every gradient leaves the
backward whole.  RoPE positions come from
``cumsum(mask) - 1`` so left-padded batches work.  The seven block linears
may be frozen int8 / int4 ``QuantLinear``s (``ops/quant.py``), and the
prefill and decode passes may take an int8 / int4 decode head made by
``quantize_head_for_decode``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from opadpo_torch.models.lora import (
    LoraConfig, init_lora_entry, lora_dense, lora_delta, tree_get,
)
from opadpo_torch.ops.attention import (
    flash_attention_fused, flash_attention_fused_shared, multi_head_attention,
)
from opadpo_torch.ops.decode_attention import ALIGN as KV_ALIGN
from opadpo_torch.ops.decode_attention import ALIGN4 as KV_ALIGN4
from opadpo_torch.ops.decode_attention import (
    decode_attention_prompt, decode_attention_prompt4,
    decode_attention_prompt_multi, unpack_int4_kv,
)
from opadpo_torch.ops.quant import QuantLinear, exact_div
from opadpo_torch.ops.rope import apply_rope, rope_frequencies
from opadpo_torch.parallel.comm import copy_to_model, gather, reduce_from_model
from opadpo_torch.parallel.sharding import ROW, split_of
from opadpo_torch.utils import trace

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def llava_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llava_13b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_layers=40, num_heads=40, num_kv_heads=40)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, hidden_size=128,
                           intermediate_size=352, num_layers=2,
                           num_heads=2, num_kv_heads=2, head_dim=64,
                           max_position_embeddings=2048)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, i, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.attn_norm = nn.Parameter(torch.empty(d, dtype=torch.float32))
        self.mlp_norm = nn.Parameter(torch.empty(d, dtype=torch.float32))
        self.wq = nn.Linear(d, nh * hd, bias=False, dtype=dt)
        self.wk = nn.Linear(d, nkv * hd, bias=False, dtype=dt)
        self.wv = nn.Linear(d, nkv * hd, bias=False, dtype=dt)
        self.wo = nn.Linear(nh * hd, d, bias=False, dtype=dt)
        self.w_gate = nn.Linear(d, i, bias=False, dtype=dt)
        self.w_up = nn.Linear(d, i, bias=False, dtype=dt)
        self.w_down = nn.Linear(i, d, bias=False, dtype=dt)
        self.tp = None            # the model group under tensor parallelism

    def enter(self, x):
        """The input of a column-parallel block entering the model
        region (the identity without tensor parallelism)."""
        return copy_to_model(x, self.tp)

    def dense(self, x, name, ll, scaling):
        """One of the seven linears (``nn.Linear`` or ``QuantLinear``)
        with its adapter entry from ``ll``; under tensor parallelism a
        column-parallel one takes ``x`` already in the region
        (``enter``) and a row-parallel one returns the sum over the model
        group."""
        entry = tree_get(ll, name)
        if self.tp is None:
            return lora_dense(x, getattr(self, name), entry, scaling)
        return _dense_tp(x, getattr(self, name), entry, scaling,
                         split_of(name), self.tp)


def _dense_tp(x, weight, entry, scaling, split, tp):
    if split != ROW:
        if entry is not None:
            entry = {"a": copy_to_model(entry["a"], tp), "b": entry["b"]}
        return lora_dense(x, weight, entry, scaling)
    if entry is not None:
        k = x.shape[-1]
        entry = {"a": copy_to_model(entry["a"], tp).narrow(1, tp.rank * k, k),
                 "b": copy_to_model(entry["b"], tp)}
    y = lora_dense(x, weight)
    delta = lora_delta(x, entry, scaling)
    y = y.float() if delta is None else y.float() + delta
    return reduce_from_model(y, tp).to(x.dtype)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.dtype
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d, dtype=dt))
        self.layers = nn.ModuleList(LlamaLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty(d, dtype=torch.float32))
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, dtype=dt)
        self.tp = None            # the model group under tensor parallelism
        self._rope = None

    def rope_tables(self):
        """f32 cos/sin tables on the weights' device, built once, as normal
        tensors even under inference mode, so that a model that served can
        train."""
        dev = self.embed.device
        if self._rope is None or self._rope[0].device != dev:
            with torch.inference_mode(False), torch.no_grad():
                self._rope = rope_frequencies(
                    self.cfg.head_dim, self.cfg.max_position_embeddings,
                    self.cfg.rope_base, device=dev)
        return self._rope


def init_lora(cfg: LlamaConfig, lora_cfg: LoraConfig,
              generator: torch.Generator) -> dict:
    """Adapters over all seven decoder linears of every layer (the
    reference's "all linear layers"), B zero."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv), "wo": (nq, d),
              "w_gate": (d, i), "w_up": (d, i), "w_down": (i, d)}
    return {"layers": [
        {name: init_lora_entry(a, b, lora_cfg, generator)
         for name, (a, b) in shapes.items()}
        for _ in range(cfg.num_layers)]}


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def embed_tokens(model: LlamaModel, input_ids: torch.Tensor):
    """Token embedding; ids < 0 (the image token, pads) map to row 0."""
    return F.embedding(torch.clamp(input_ids, min=0), model.embed)


def _qkv_proj(x, layer: LlamaLayer, ll, scaling):
    x = layer.enter(x)
    return tuple(layer.dense(x, n, ll, scaling) for n in ("wq", "wk", "wv"))


def _mlp_block(x, layer: LlamaLayer, ll, scaling):
    x = layer.enter(x)
    gate = layer.dense(x, "w_gate", ll, scaling)
    up = layer.dense(x, "w_up", ll, scaling)
    h = F.silu(gate.float()).to(x.dtype) * up
    return layer.dense(h, "w_down", ll, scaling)


def _head_logits(model: LlamaModel, x, lora, scaling, head=None):
    """f32 logits of the final-norm hidden states ``x`` through the lm_head
    (or the quantized decode ``head``) and its adapter entry, gathered
    over the vocabulary under tensor parallelism."""
    tp = model.tp
    entry = tree_get(lora, "lm_head")
    if tp is not None:
        x = copy_to_model(x, tp)
        if entry is not None:
            entry = {"a": copy_to_model(entry["a"], tp), "b": entry["b"]}
    if head is None:
        logits = F.linear(x.float(), model.lm_head.weight.float())
    else:
        logits = head.matmul_f32(x.reshape(-1, x.shape[-1])).reshape(
            *x.shape[:-1], -1)
    delta = lora_delta(x, entry, scaling)
    if delta is not None:
        logits = logits + delta
    return gather(logits, tp, dim=-1)


@torch.no_grad()
def quantize_head_for_decode(model: LlamaModel,
                             bits: int) -> Optional[QuantLinear]:
    """The lm_head as an int8 (``bits`` 8) or int4 (4) ``QuantLinear`` for
    the decode passes, or None for 16.  Training and scoring keep the bf16
    head (the reference skips lm_head); the sampler opts in with
    ``head_bits``, since decode re-reads the whole head every token."""
    if bits == 16:
        return None
    if bits not in (8, 4):
        raise ValueError(f"head_bits={bits}")
    q = QuantLinear.from_weight(model.lm_head.weight, bits)
    if q.bits != bits:
        raise ValueError(f"hidden size {model.cfg.hidden_size} is not a "
                         "multiple of the int4 group")
    return q


def _decode_head(x, model: LlamaModel, lora, scaling, head=None):
    """Final norm + lm_head on [B, G, D] -> f32 logits [B, G, V] (the bf16
    products summed in f32, as the JAX head's f32 accumulation).  ``head``:
    a quantized decode head, through the int8 / int4 kernel with f32
    output."""
    x = rms_norm(x, model.final_norm, model.cfg.rms_norm_eps)
    return _head_logits(model, x, lora, scaling, head)


def _repeat_kv(t, cfg: LlamaConfig):
    rep = cfg.num_heads // cfg.num_kv_heads
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=2)


def forward_prefill_unrolled(model: LlamaModel, input_embeds, key_mask,
                             positions, lora=None, lora_scaling: float = 1.0,
                             head: Optional[QuantLinear] = None):
    """Prompt pass -> (last-position logits [B, V] f32, [(k, v), ...] per
    layer, each [B, S, Hkv, hd] after RoPE); ``head`` as for
    ``_decode_head``."""
    cfg = model.cfg
    b, s, _ = input_embeds.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = model.rope_tables()
    x = input_embeds
    kv_list = []
    for i, layer in enumerate(model.layers):
        ll = tree_get(lora, "layers", i)
        h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
        q, k, v = _qkv_proj(h, layer, ll, lora_scaling)
        q = q.view(b, s, nh, hd)
        k = k.view(b, s, nkv, hd)
        v = v.view(b, s, nkv, hd)
        q, k = apply_rope(q, k, cos, sin, positions)
        kv_list.append((k, v))
        attn = multi_head_attention(q, _repeat_kv(k, cfg),
                                    _repeat_kv(v, cfg), key_mask=key_mask,
                                    causal=True)
        x = x + layer.dense(attn.reshape(b, s, nh * hd), "wo", ll,
                            lora_scaling)
        h = rms_norm(x, layer.mlp_norm, cfg.rms_norm_eps)
        x = x + _mlp_block(h, layer, ll, lora_scaling)
    return (_decode_head(x[:, -1:, :], model, lora, lora_scaling,
                         head)[:, 0], kv_list)


def maybe_remat(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` is
    set and grad is enabled (the decoder's layers and the CLIP blocks);
    its recompute in the backward is the span ``remat.layer``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(trace.rerun_span(fn, "remat.layer"), *args,
                          use_reentrant=False)
    return fn(*args)


def _train_layer(x, layer: LlamaLayer, ll, key_mask, positions, cfg,
                 scaling, cos, sin):
    h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
    q, k, v = _qkv_proj(h, layer, ll, scaling)
    attn = flash_attention_fused(q, k, v, cos, sin, positions,
                                 cfg.num_heads, key_mask=key_mask,
                                 causal=True, num_kv_heads=cfg.num_kv_heads)
    x = x + layer.dense(attn, "wo", ll, scaling)
    h = rms_norm(x, layer.mlp_norm, cfg.rms_norm_eps)
    return x + _mlp_block(h, layer, ll, scaling)


def forward(model: LlamaModel, input_embeds, key_mask, positions, lora=None,
            lora_scaling: float = 1.0, remat: bool = True,
            return_hidden: bool = False):
    """Decoder over whole sequences -> f32 logits [B, S, V], or with
    ``return_hidden`` the final-norm hidden states [B, S, D] (for the
    chunked readout of ``ops/logprobs``)."""
    cfg = model.cfg
    cos, sin = model.rope_tables()
    x = input_embeds
    for i, layer in enumerate(model.layers):
        x = maybe_remat(_train_layer, remat, x, layer,
                        tree_get(lora, "layers", i), key_mask, positions,
                        cfg, lora_scaling, cos, sin)
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    if return_hidden:
        return x
    return _head_logits(model, x, lora, lora_scaling)


def _shared_layer(xp, xr, layer: LlamaLayer, ll, masks, positions, cfg,
                  scaling, cos, sin):
    hp = rms_norm(xp, layer.attn_norm, cfg.rms_norm_eps)
    hr = rms_norm(xr, layer.attn_norm, cfg.rms_norm_eps)
    op2, or2 = flash_attention_fused_shared(
        *_qkv_proj(hp, layer, ll, scaling), *_qkv_proj(hr, layer, ll, scaling),
        cos, sin, positions[0], positions[1], cfg.num_heads, masks[0],
        masks[1], num_kv_heads=cfg.num_kv_heads)
    xp = xp + layer.dense(op2, "wo", ll, scaling)
    xr = xr + layer.dense(or2, "wo", ll, scaling)
    hp = rms_norm(xp, layer.mlp_norm, cfg.rms_norm_eps)
    hr = rms_norm(xr, layer.mlp_norm, cfg.rms_norm_eps)
    return (xp + _mlp_block(hp, layer, ll, scaling),
            xr + _mlp_block(hr, layer, ll, scaling))


def forward_shared_prefix(model: LlamaModel, prefix_embeds, prefix_mask,
                          prefix_positions, resp_embeds, resp_mask,
                          resp_positions, lora=None,
                          lora_scaling: float = 1.0, remat: bool = True):
    """Decoder over a shared prefix [B, Sp] and K responses per example
    [K*B, Sr], stacked B-major (row b*K + t): the prefix runs once and the
    responses attend to [prefix ++ self] (``flash_attention_fused_shared``);
    the same numbers as the stacked layout, with the prefix computed once
    instead of K times.  Returns the final-norm hidden states ``(hp [B, Sp,
    D], hr [K*B, Sr, D])``."""
    cfg = model.cfg
    cos, sin = model.rope_tables()
    masks = (prefix_mask, resp_mask)
    positions = (prefix_positions, resp_positions)
    xp, xr = prefix_embeds, resp_embeds
    for i, layer in enumerate(model.layers):
        xp, xr = maybe_remat(_shared_layer, remat, xp, xr, layer,
                             tree_get(lora, "layers", i), masks, positions,
                             cfg, lora_scaling, cos, sin)
    return (rms_norm(xp, model.final_norm, cfg.rms_norm_eps),
            rms_norm(xr, model.final_norm, cfg.rms_norm_eps))


def init_suffix_cache(cfg: LlamaConfig, batch: int, n: int,
                      device) -> list:
    """Per layer a zero bf16 (model dtype) suffix buffer pair
    ([B, n, Hkv, hd], the same) for the decode steps to write in place."""
    shape = (batch, n, cfg.num_kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.num_layers)]


def _head_major(q, scale, total_len, align):
    """[B, Sp, H, hd] codes and [B, Sp, H] scales -> head-major, padded
    with zeros to an ``align``-multiple or to ``total_len``."""
    q = q.permute(0, 2, 1, 3)
    scale = scale.permute(0, 2, 1)
    sp = q.shape[2]
    sp_pad = total_len if total_len is not None else -(-sp // align) * align
    if sp_pad < sp or sp_pad % align:
        raise ValueError(f"cache length {sp_pad} must be a multiple of "
                         f"{align} and >= {sp}")
    q = F.pad(q, (0, 0, 0, sp_pad - sp))
    scale = F.pad(scale, (0, sp_pad - sp))
    return q.contiguous(), scale.contiguous()


def quantize_prompt_kv(kv: torch.Tensor,
                       total_len: Optional[int] = None) -> dict:
    """[B, Sp, H, hd] -> {"q": int8 [B, H, Sp_pad, hd], "scale": f32
    [B, H, Sp_pad]}: symmetric per-(b, s, h) int8 with scale
    max(amax, 1e-8)/127 and round-half-even, HEAD-MAJOR, padded with zero
    values and zero scales to a 128-multiple, or to ``total_len`` (chunked
    decode preallocates the cache at its final length)."""
    kv32 = kv.float()
    scale = exact_div(torch.clamp(kv32.abs().amax(dim=-1), min=1e-8), 127.0)
    q = torch.round(kv32 / scale[..., None]).to(torch.int8)
    q, scale = _head_major(q, scale, total_len, KV_ALIGN)
    return {"q": q, "scale": scale}


def _int4_codes(kv: torch.Tensor):
    """[B, Sp, H, hd] -> (int32 codes in [-8, 7], f32 scales [B, Sp, H]):
    symmetric per-(b, s, h), scale max(amax, 1e-8)/7, round-half-even."""
    kv32 = kv.float()
    scale = exact_div(torch.clamp(kv32.abs().amax(dim=-1), min=1e-8), 7.0)
    q = torch.clamp(torch.round(kv32 / scale[..., None]), -8, 7).to(
        torch.int32)
    return q, scale


def quantize_prompt_kv_int4_values(kv: torch.Tensor) -> dict:
    """The int4 codes unpacked: [B, Sp, H, hd] -> {"qv": int32 [B, H, Sp,
    hd] in [-8, 7], "scale": f32 [B, H, Sp]}, head-major and unpadded, the
    values ``quantize_prompt_kv_int4`` packs (the continuous engine's
    per-row fold writes them at arbitrary offsets)."""
    q, scale = _int4_codes(kv)
    return {"qv": q.permute(0, 2, 1, 3), "scale": scale.permute(0, 2, 1)}


def quantize_prompt_kv_int4(kv: torch.Tensor,
                            total_len: Optional[int] = None) -> dict:
    """int4 variant: [B, Sp, H, hd] -> {"q4": int8 [B, H, Sp_pad/2, hd],
    "scale": f32 [B, H, Sp_pad]}, scale max(amax, 1e-8)/7, codes clipped
    to [-8, 7], Sp_pad a 256-multiple (or ``total_len``).  Packed
    GROUP-LOCAL HALF-SPLIT as the JAX package packs it: byte ``g*128 + r``
    holds position ``g*256 + r`` in its low nibble and ``g*256 + 128 + r``
    in its high nibble.  Scales and the mask keep the int8 layout."""
    q, scale = _int4_codes(kv)
    q, scale = _head_major(q, scale, total_len, KV_ALIGN4)
    b, h, sp, hd = q.shape
    qg = q.view(b, h, sp // 256, 256, hd)
    packed = (qg[:, :, :, 128:] * 16 + (qg[:, :, :, :128] & 0xF)).to(
        torch.int8)
    return {"q4": packed.reshape(b, h, sp // 2, hd), "scale": scale}


def dequantize_prompt_kv_int4(pkq: dict) -> torch.Tensor:
    """Inverse of ``quantize_prompt_kv_int4`` -> head-major f32
    [B, H, Sp_pad, hd]."""
    return unpack_int4_kv(pkq["q4"]).float() * pkq["scale"][..., None]


def quantize_prompt_kv_list(kv_list: list, total_len: Optional[int] = None,
                            kv_bits: int = 8) -> list:
    """[(k, v), ...] -> the int8 (``kv_bits`` 8) or packed int4 (4) cache
    of each layer."""
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits={kv_bits}: the quantized cache is 8 or 4")
    fn = quantize_prompt_kv if kv_bits == 8 else quantize_prompt_kv_int4
    return [(fn(k, total_len), fn(v, total_len)) for k, v in kv_list]


def fold_suffix_into_prompt_kv(kv_list: list, suffix_list: list,
                               prompt_mask: torch.Tensor, filled: int,
                               offset: int) -> tuple:
    """Chunked decode's fold, IN PLACE: each layer's bf16 suffix
    ``[B, C, H, hd]`` is quantized like the cache and written into the
    cache preallocated at its final length at positions
    ``[offset, offset + C)`` (packed rows ``offset/2`` on for int4), and
    ``prompt_mask`` (cache layout) is set over ``[offset, offset +
    filled)``.  The JAX package returns new arrays under buffer donation;
    here the slice copies are the in-place update, so no cache is ever held
    twice.  Returns ``(kv_list, prompt_mask)``, the objects given."""
    c = suffix_list[0][0].shape[1]
    int4 = "q4" in kv_list[0][0]
    align = KV_ALIGN4 if int4 else KV_ALIGN
    if c % align or offset % align:
        raise ValueError(f"suffix length {c} and offset {offset} must be "
                         f"multiples of {align}")
    for pair, suffix in zip(kv_list, suffix_list):
        for cache, new in zip(pair, suffix):
            if int4:
                qn = quantize_prompt_kv_int4(new)
                cache["q4"][:, :, offset // 2:(offset + c) // 2] = qn["q4"]
            else:
                qn = quantize_prompt_kv(new)
                cache["q"][:, :, offset:offset + c] = qn["q"]
            cache["scale"][:, :, offset:offset + c] = qn["scale"]
    prompt_mask[:, offset:offset + filled] = 1
    return kv_list, prompt_mask


def prompt_bias(prompt_mask: torch.Tensor, sp_pad: int) -> torch.Tensor:
    """Additive f32 bias [B, sp_pad] for the decode kernels: 0 where the
    prompt is valid, -1e30 on masked positions and on the padding."""
    bias = torch.where(prompt_mask != 0, 0.0, NEG_INF).to(torch.float32)
    return F.pad(bias, (0, sp_pad - prompt_mask.shape[1]), value=NEG_INF)


def _decode_setup(model: LlamaModel, prompt_kv: list, prompt_mask):
    """(cos, sin, prompt mask [B, 1, 1, Sp] bool, the kernels' prompt bias
    or None for a bf16 cache)."""
    cfg = model.cfg
    if cfg.num_heads != cfg.num_kv_heads:
        raise NotImplementedError("grouped-query decode")
    cos, sin = model.rope_tables()
    pbias = None
    if isinstance(prompt_kv[0][0], dict):
        pbias = prompt_bias(prompt_mask, prompt_kv[0][0]["scale"].shape[2])
    return cos, sin, (prompt_mask != 0)[:, None, None, :], pbias


def _qkv_rope(x, layer: LlamaLayer, ll, cfg, scaling, cos, sin, positions):
    """G tokens [B, G, D], the first at RoPE position ``positions`` [B] ->
    (q [B, H, G, hd], k, v [B, G, H, hd]) after RoPE."""
    b, g = x.shape[:2]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
    q, k, v = _qkv_proj(h, layer, ll, scaling)
    pos = positions[:, None] + torch.arange(g, device=x.device)
    q, k = apply_rope(q.view(b, g, nh, hd), k.view(b, g, nkv, hd), cos, sin,
                      pos)
    return q.transpose(1, 2), k, v.view(b, g, nkv, hd)


def _attend(qh, pk, pv, pm, pbias, sp_used, pieces):
    """Softmax attention of queries ``qh`` [B, H, G, hd] over the prompt
    cache and the suffix ``pieces`` -> normalised output [B, H, G, hd] f32.

    ``pieces``: [(scores [B, H, G, S] f32, -1e30 where a query does not
    see a row; values [B, S, H, hd])].  A bf16 cache (``pk``/``pv``
    [B, Sp, H, hd]) joins one softmax with them; a quantized one (dicts)
    goes through its kernel, one query per head (#6, or #7 over int4) or
    G at once (#8), and merges with the pieces by logsumexp."""
    scale = qh.shape[-1] ** -0.5
    if not isinstance(pk, dict):
        sp = torch.einsum("bhgd,bshd->bhgs", qh.float(), pk.float()) * scale
        sp = torch.where(pm, sp, NEG_INF)
        pieces = [(sp, pv)] + pieces
        probs = torch.softmax(torch.cat([s for s, _ in pieces], dim=-1),
                              dim=-1)
        out, start = 0.0, 0
        for s, val in pieces:
            n = s.shape[-1]
            out = out + torch.einsum(
                "bhgs,bshd->bhgd", probs[..., start:start + n].to(
                    val.dtype).float(), val.float())
            start += n
        return out
    g = qh.shape[2]
    if "q4" in pk:
        if g != 1:
            raise ValueError("the int4 cache takes one query per head")
        res = decode_attention_prompt4(qh[:, :, 0], pk["q4"], pk["scale"],
                                       pv["q4"], pv["scale"], pbias, scale,
                                       s_used=sp_used)
    elif g == 1:
        res = decode_attention_prompt(qh[:, :, 0], pk["q"], pk["scale"],
                                      pv["q"], pv["scale"], pbias, scale,
                                      s_used=sp_used)
    else:
        res = decode_attention_prompt_multi(qh, pk["q"], pk["scale"], pv["q"],
                                            pv["scale"], pbias, scale,
                                            s_used=sp_used)
    out_p, m_p, l_p = (t[:, :, None] for t in res) if g == 1 else res
    m = m_p
    for s, _ in pieces:
        m = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m_p - m)
    l = l_p * alpha
    out = out_p * alpha[..., None]
    for s, val in pieces:
        p = torch.exp(s - m[..., None])
        l = l + p.sum(dim=-1)
        out = out + torch.einsum("bhgs,bshd->bhgd", p.to(val.dtype).float(),
                                 val.float())
    return out / l[..., None]


def _finish_layer(x, out, layer: LlamaLayer, ll, cfg, scaling):
    """Attention output [B, H, G, hd] -> o-projection, residual, MLP."""
    b, g = x.shape[:2]
    attn = out.transpose(1, 2).reshape(b, g, -1).to(x.dtype)
    x = x + layer.dense(attn, "wo", ll, scaling)
    h = rms_norm(x, layer.mlp_norm, cfg.rms_norm_eps)
    return x + _mlp_block(h, layer, ll, scaling)


def _decode_layer(x, layer: LlamaLayer, ll, pk, pv, sk, sv, *, cfg,
                  lora_scaling, positions, step, pm, pbias, cos, sin,
                  sp_used=None):
    """One layer's step for G tokens [B, G, D]: a decode step at G = 1, a
    speculative verify group above.  Writes their k, v into the suffix
    buffers at rows ``[step, step + G)`` in place; query g sees suffix rows
    <= step + g and the whole prompt.

    ``pk``/``pv`` are bf16 [B, Sp, H, hd], or int8 / int4 dicts from
    ``quantize_prompt_kv`` / ``quantize_prompt_kv_int4``."""
    g = x.shape[1]
    qh, k, v = _qkv_rope(x, layer, ll, cfg, lora_scaling, cos, sin,
                         positions)
    sk[:, step:step + g] = k.to(sk.dtype)
    sv[:, step:step + g] = v.to(sv.dtype)
    ss = torch.einsum("bhgd,bshd->bhgs", qh.float(),
                      sk.float()) * cfg.head_dim ** -0.5
    rows = torch.arange(sk.shape[1], device=x.device)
    seen = rows[None, :] <= step + torch.arange(g, device=x.device)[:, None]
    ss = torch.where(seen, ss, NEG_INF)
    out = _attend(qh, pk, pv, pm, pbias, sp_used, [(ss, sv)])
    return _finish_layer(x, out, layer, ll, cfg, lora_scaling)


def _decode_layer_pr(x, layer: LlamaLayer, ll, pk, pv, rk, rv, ck, cv, *,
                     cfg, lora_scaling, positions, slot, raw_ok, w, pm, pbias,
                     cos, sin, sp_used=None):
    """The per-row speculative verify layer (``decode_forward_multi_pr``).
    Two suffix regions replace the batch-uniform buffer:

    - raw ``rk``/``rv`` [B, Craw, H, hd]: every group writes its G rows at
      the shared ``slot``; ``raw_ok`` [B, Craw] marks the rows earlier
      groups accepted, per row, and the group sees its own rows causally;
    - settled ``ck``/``cv`` [B, Ntot, H, hd]: row t holds generated token
      t, valid below the per-row watermark ``w`` [B] (written by
      ``engine/speculative.compact_suffix_pr``)."""
    g = x.shape[1]
    qh, k, v = _qkv_rope(x, layer, ll, cfg, lora_scaling, cos, sin,
                         positions)
    rk[:, slot:slot + g] = k.to(rk.dtype)
    rv[:, slot:slot + g] = v.to(rv.dtype)
    scale = cfg.head_dim ** -0.5
    dev = x.device
    rs = torch.einsum("bhgd,bshd->bhgs", qh.float(), rk.float()) * scale
    col = torch.arange(rk.shape[1], device=dev)[None, :]
    qi = torch.arange(g, device=dev)[:, None]
    ingroup = (col >= slot) & (col <= slot + qi)                # [G, Craw]
    rs = torch.where(raw_ok[:, None, None, :] | ingroup, rs, NEG_INF)
    cs = torch.einsum("bhgd,bshd->bhgs", qh.float(), ck.float()) * scale
    settled = torch.arange(ck.shape[1], device=dev)[None, :] < w[:, None]
    cs = torch.where(settled[:, None, None, :], cs, NEG_INF)
    out = _attend(qh, pk, pv, pm, pbias, sp_used, [(rs, rv), (cs, cv)])
    return _finish_layer(x, out, layer, ll, cfg, lora_scaling)


def decode_forward_multi(model: LlamaModel, embeds, prompt_kv: list,
                         prompt_mask, suffix_kv: list, step: int, positions,
                         lora=None, lora_scaling: float = 1.0,
                         sp_used: Optional[int] = None,
                         head: Optional[QuantLinear] = None):
    """G tokens through every layer -> (logits [B, G, V] f32, suffix_kv).

    embeds [B, G, D], the first at RoPE position ``positions`` [B];
    prompt_kv: per layer (pk, pv); prompt_mask [B, Sp] (cache layout for a
    preallocated cache); suffix_kv: per layer (sk, sv) [B, Nmax, Hkv, hd],
    written at rows ``[step, step + G)`` in place; ``sp_used`` the fill
    watermark the prompt kernels read to; ``head`` as for
    ``_decode_head``.  A speculative verify group reads the prompt cache
    once for all G tokens (kernel #8)."""
    cos, sin, pm, pbias = _decode_setup(model, prompt_kv, prompt_mask)
    kw = dict(cfg=model.cfg, lora_scaling=lora_scaling, positions=positions,
              step=step, pm=pm, pbias=pbias, cos=cos, sin=sin,
              sp_used=sp_used)
    x = embeds
    for i, layer in enumerate(model.layers):
        x = _decode_layer(x, layer, tree_get(lora, "layers", i),
                          *prompt_kv[i], *suffix_kv[i], **kw)
    return _decode_head(x, model, lora, lora_scaling, head), suffix_kv


def decode_forward_unrolled(model: LlamaModel, embeds, prompt_kv: list,
                            prompt_mask, suffix_kv: list, step: int,
                            positions, lora=None, lora_scaling: float = 1.0,
                            sp_used: Optional[int] = None,
                            head: Optional[QuantLinear] = None):
    """One-token decode, embeds [B, 1, D] -> (logits [B, V] f32,
    suffix_kv); see ``decode_forward_multi``."""
    logits, suffix_kv = decode_forward_multi(
        model, embeds, prompt_kv, prompt_mask, suffix_kv, step, positions,
        lora=lora, lora_scaling=lora_scaling, sp_used=sp_used, head=head)
    return logits[:, 0], suffix_kv


def decode_forward_multi_pr(model: LlamaModel, embeds, prompt_kv: list,
                            prompt_mask, raw_kv: list, settled_kv: list,
                            slot: int, raw_ok, w, positions, lora=None,
                            lora_scaling: float = 1.0,
                            sp_used: Optional[int] = None,
                            head: Optional[QuantLinear] = None):
    """G-token verify with PER-ROW acceptance (``_decode_layer_pr``) ->
    (logits [B, G, V] f32, raw_kv, written at ``slot`` in place)."""
    cos, sin, pm, pbias = _decode_setup(model, prompt_kv, prompt_mask)
    kw = dict(cfg=model.cfg, lora_scaling=lora_scaling, positions=positions,
              slot=slot, raw_ok=raw_ok, w=w, pm=pm, pbias=pbias, cos=cos,
              sin=sin, sp_used=sp_used)
    x = embeds
    for i, layer in enumerate(model.layers):
        x = _decode_layer_pr(x, layer, tree_get(lora, "layers", i),
                             *prompt_kv[i], *raw_kv[i], *settled_kv[i], **kw)
    return _decode_head(x, model, lora, lora_scaling, head), raw_kv
