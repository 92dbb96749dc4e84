"""LLaMA / Vicuna decoder: port of ``opadpo_tpu/models/llama.py``.

- ``forward`` and ``forward_shared_prefix``: the training / scoring
  passes over whole sequences, each layer under
  ``torch.utils.checkpoint`` when ``remat`` (the JAX package's
  ``jax.checkpoint`` on its layer scan), attention through the fused
  RoPE + head-layout + flash composites of ``ops/attention``.
- ``forward_prefill_unrolled``: the prompt pass, returning the last
  position's logits and every layer's (k, v), with causal attention on the
  flash kernel (``ops/attention``).
- ``quantize_prompt_kv``: per-(b, s, h) symmetric int8, head-major, padded
  to a 128-multiple with zero scales.
- ``decode_forward_unrolled``: one token through every layer against the
  prompt KV (bf16, or int8 through the decode-attention kernel) and a small
  bf16 suffix buffer that the step writes in place, merged by logsumexp.

Projections run in the model dtype and widen to f32 for the LoRA sum; the
decode head returns f32 logits.  RoPE positions come from
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
from opadpo_torch.ops.decode_attention import decode_attention_prompt
from opadpo_torch.ops.quant import QuantLinear, exact_div
from opadpo_torch.ops.rope import apply_rope, rope_frequencies

NEG_INF = -1e30
KV_ALIGN = 128


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

    def dense(self, x, name, ll, scaling):
        """One of the seven linears (``nn.Linear`` or ``QuantLinear``)
        with its adapter entry from ``ll``."""
        return lora_dense(x, getattr(self, name), tree_get(ll, name),
                          scaling)


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
    return tuple(layer.dense(x, n, ll, scaling) for n in ("wq", "wk", "wv"))


def _mlp_block(x, layer: LlamaLayer, ll, scaling):
    gate = layer.dense(x, "w_gate", ll, scaling)
    up = layer.dense(x, "w_up", ll, scaling)
    h = F.silu(gate.float()).to(x.dtype) * up
    return layer.dense(h, "w_down", ll, scaling)


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
    """Final norm + lm_head on [B, 1, D] -> f32 logits [B, V] (the bf16
    products summed in f32, as the JAX head's f32 accumulation).  ``head``:
    a quantized decode head, through the int8 / int4 kernel with f32
    output."""
    x = rms_norm(x, model.final_norm, model.cfg.rms_norm_eps)
    if head is None:
        logits = F.linear(x.float(), model.lm_head.weight.float())
    else:
        logits = head.matmul_f32(x.reshape(-1, x.shape[-1])).reshape(
            *x.shape[:-1], -1)
    delta = lora_delta(x, tree_get(lora, "lm_head"), scaling)
    if delta is not None:
        logits = logits + delta
    return logits[:, 0]


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
    return (_decode_head(x[:, -1:, :], model, lora, lora_scaling, head),
            kv_list)


def _maybe_remat(fn, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
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
        x = _maybe_remat(_train_layer, remat, x, layer,
                         tree_get(lora, "layers", i), key_mask, positions,
                         cfg, lora_scaling, cos, sin)
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    if return_hidden:
        return x
    logits = F.linear(x.float(), model.lm_head.weight.float())
    delta = lora_delta(x, tree_get(lora, "lm_head"), lora_scaling)
    return logits if delta is None else logits + delta


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
        xp, xr = _maybe_remat(_shared_layer, remat, xp, xr, layer,
                              tree_get(lora, "layers", i), masks, positions,
                              cfg, lora_scaling, cos, sin)
    return (rms_norm(xp, model.final_norm, cfg.rms_norm_eps),
            rms_norm(xr, model.final_norm, cfg.rms_norm_eps))


def quantize_prompt_kv(kv: torch.Tensor) -> dict:
    """[B, Sp, H, hd] -> {"q": int8 [B, H, Sp_pad, hd], "scale": f32
    [B, H, Sp_pad]}: symmetric per-(b, s, h) int8 with scale
    max(amax, 1e-8)/127 and round-half-even, HEAD-MAJOR, padded to a
    128-multiple with zero values and zero scales."""
    kv32 = kv.float()
    amax = kv32.abs().amax(dim=-1)
    scale = exact_div(torch.clamp(amax, min=1e-8), 127.0)
    q = torch.round(kv32 / scale[..., None]).to(torch.int8)
    q = q.permute(0, 2, 1, 3)
    scale = scale.permute(0, 2, 1)
    pad = -q.shape[2] % KV_ALIGN
    q = F.pad(q, (0, 0, 0, pad))
    scale = F.pad(scale, (0, pad))
    return {"q": q.contiguous(), "scale": scale.contiguous()}


def quantize_prompt_kv_list(kv_list: list) -> list:
    return [(quantize_prompt_kv(k), quantize_prompt_kv(v))
            for k, v in kv_list]


def prompt_bias(prompt_mask: torch.Tensor, sp_pad: int) -> torch.Tensor:
    """Additive f32 bias [B, sp_pad] for the decode kernel: 0 where the
    prompt is valid, -1e30 on masked positions and on the padding."""
    bias = torch.where(prompt_mask != 0, 0.0, NEG_INF).to(torch.float32)
    return F.pad(bias, (0, sp_pad - prompt_mask.shape[1]), value=NEG_INF)


def _decode_layer(x, layer: LlamaLayer, ll, pk, pv, sk, sv, *, cfg,
                  lora_scaling, positions, step, suf_valid, pm, cos, sin,
                  pbias=None, sp_used=None):
    """One layer's single-token step over (prompt, suffix) KV.  Writes the
    token's k, v into the suffix buffers ``sk``/``sv`` at ``step`` in place.

    ``pk``/``pv`` are bf16 [B, Sp, H, hd] or int8 dicts from
    ``quantize_prompt_kv`` (the decode-attention kernel reads those)."""
    b = x.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    h = rms_norm(x, layer.attn_norm, cfg.rms_norm_eps)
    q, k, v = _qkv_proj(h, layer, ll, lora_scaling)
    q = q.view(b, 1, nh, hd)
    k = k.view(b, 1, nkv, hd)
    v = v.view(b, 1, nkv, hd)
    q, k = apply_rope(q, k, cos, sin, positions[:, None])
    sk[:, step] = k[:, 0].to(sk.dtype)
    sv[:, step] = v[:, 0].to(sv.dtype)

    qh = q[:, 0]                                            # [B, H, hd]
    ss = torch.einsum("bhd,bshd->bhs", qh.float(), sk.float()) * scale
    ss = torch.where(suf_valid, ss, NEG_INF)
    if isinstance(pk, dict):
        out_p, m_p, l_p = decode_attention_prompt(
            qh.to(x.dtype).contiguous(), pk["q"], pk["scale"], pv["q"],
            pv["scale"], pbias, scale, s_used=sp_used)
        m = torch.maximum(m_p, ss.amax(dim=-1))
        alpha_p = torch.exp(m_p - m)
        p_s = torch.exp(ss - m[..., None])
        l = l_p * alpha_p + p_s.sum(dim=-1)
        out_s = torch.einsum("bhs,bshd->bhd", p_s.to(sv.dtype).float(),
                             sv.float())
        out = (out_p * alpha_p[..., None] + out_s) / l[..., None]
    else:
        sp_scores = torch.einsum("bhd,bshd->bhs", qh.float(),
                                 pk.float()) * scale
        sp_scores = torch.where(pm, sp_scores, NEG_INF)
        sp_n = pk.shape[1]
        probs = torch.softmax(torch.cat([sp_scores, ss], dim=-1), dim=-1)
        out = (torch.einsum("bhs,bshd->bhd",
                            probs[..., :sp_n].to(pv.dtype).float(),
                            pv.float())
               + torch.einsum("bhs,bshd->bhd",
                              probs[..., sp_n:].to(sv.dtype).float(),
                              sv.float()))
    attn = out.reshape(b, 1, nh * hd).to(x.dtype)
    x = x + layer.dense(attn, "wo", ll, lora_scaling)
    h = rms_norm(x, layer.mlp_norm, cfg.rms_norm_eps)
    return x + _mlp_block(h, layer, ll, lora_scaling)


def decode_forward_unrolled(model: LlamaModel, embeds, prompt_kv: list,
                            prompt_mask, suffix_kv: list, step: int,
                            positions, lora=None, lora_scaling: float = 1.0,
                            sp_used: Optional[int] = None,
                            head: Optional[QuantLinear] = None):
    """One-token decode -> (logits [B, V] f32, suffix_kv).

    embeds [B, 1, D]; prompt_kv: per layer (pk, pv); prompt_mask [B, Sp];
    suffix_kv: per layer (sk, sv) [B, Nmax, Hkv, hd], written at ``step``
    in place (the new token attends to suffix slots 0..step); positions
    [B], the new token's RoPE position; ``head`` as for ``_decode_head``."""
    cfg = model.cfg
    if cfg.num_heads != cfg.num_kv_heads:
        raise NotImplementedError("grouped-query decode")
    n_max = suffix_kv[0][0].shape[1]
    cos, sin = model.rope_tables()
    dev = embeds.device
    suf_valid = (torch.arange(n_max, device=dev) <= step)[None, None, :]
    pm = (prompt_mask != 0)[:, None, :]
    pbias = None
    if isinstance(prompt_kv[0][0], dict):
        pbias = prompt_bias(prompt_mask, prompt_kv[0][0]["scale"].shape[2])
    kw = dict(cfg=cfg, lora_scaling=lora_scaling, positions=positions,
              step=step, suf_valid=suf_valid, pm=pm, cos=cos, sin=sin,
              pbias=pbias, sp_used=sp_used)
    x = embeds
    for i, layer in enumerate(model.layers):
        pk, pv = prompt_kv[i]
        sk, sv = suffix_kv[i]
        x = _decode_layer(x, layer, tree_get(lora, "layers", i), pk, pv, sk,
                          sv, **kw)
    return _decode_head(x, model, lora, lora_scaling, head), suffix_kv
