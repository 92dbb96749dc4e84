"""A plain LLaVA-1.5 over any LLaMA-equation decoder, in float32 PyTorch:
the benchmark's reference for what the program computes.

It follows the published description and imports nothing of the program:

- CLIP ViT (HF ``CLIPVisionModel``): a stride-p convolution over the image,
  the class and position embeddings, the pre-LayerNorm, pre-LN blocks with
  quick_gelu and bidirectional attention, the hidden state of layer
  ``mm_vision_select_layer`` without its class token;
- the mlp2x_gelu projector (Linear, exact GELU, Linear);
- the patches spliced in at each row's image token (id -200);
- the decoder: RMSNorm, rotary positions (the two halves of each head
  rotated, positions counted over the valid tokens), causal multi-head
  attention over the valid keys, the SwiGLU MLP, an untied head;
- LoRA ``y = x W^T + (x A^T) B^T * alpha / r`` on the decoder's seven
  block linears and, where the recipe tunes the vision tower, on the six
  linears of each CLIP block and the projector's two.

Weights are the bf16 tensors the benchmark drew (llava-hf names), widened
to f32 where they are used; the block linears follow the configuration's
stated precision (``reference/quant.py``).  TF32 is off while the
reference runs.  The decoder and the CLIP tower run layer by layer, each
layer under ``torch.utils.checkpoint`` when gradients are on, so 30
layers at the timed sizes fit beside the weights.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_h100.reference import quant

IMAGE_TOKEN = -200
IGNORE = -100
NEG = -1e30
LM = "model.language_model."
VT = "model.vision_tower.vision_model."
PJ = "model.multi_modal_projector."
DEC = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
       "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
       "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
       "w_down": "mlp.down_proj"}


class NoTF32:
    """TF32 off for f32 products while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


class Llava:
    def __init__(self, cfg: dict, weights: dict, precision: dict):
        self.cfg, self.w, self.precision = cfg, weights, precision
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.hd = self.d // self.h
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])

    # -- pieces -----------------------------------------------------------

    def f32(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def block_linear(self, x, name: str, entry: Optional[dict] = None,
                     scaling: float = 1.0):
        y = quant.base_product(x, self.w[name], self.precision)
        if entry is not None:
            y = y + (x @ entry["a"].float().t()) @ entry["b"].float().t() \
                * scaling
        return y

    def rms(self, x, name: str):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * self.f32(name)

    def rope(self, x, positions):
        """x [N, S, H, hd], positions [N, S]."""
        half = self.hd // 2
        inv = self.theta ** (-torch.arange(0, half, device=x.device,
                                           dtype=torch.float64) * 2
                             / self.hd)
        ang = positions.double()[..., None] * inv
        cos = torch.cos(ang).float()[:, :, None, :]
        sin = torch.sin(ang).float()[:, :, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attend(self, q, k, v, allowed):
        """q [N, Sq, H, hd], k/v [N, Sk, H, hd], allowed [N, Sq, Sk] bool."""
        s = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(self.hd)
        s = s.masked_fill(~allowed[:, None], NEG)
        return torch.einsum("nhqk,nkhd->nqhd", torch.softmax(s, -1), v)

    # -- vision -------------------------------------------------------------

    def vision_features(self, images, lora=None,
                        scaling: float = 1.0) -> torch.Tensor:
        """[B, H, W, 3] normalised images -> projected patches [B, P, D];
        ``lora`` = (per-block entries, projector entries) or None."""
        v = self.cfg["vision"]
        vd = v["hidden_size"]
        e = VT + "embeddings."
        x = F.conv2d(images.float().permute(0, 3, 1, 2),
                     self.f32(e + "patch_embedding.weight"),
                     stride=v["patch_size"])
        x = x.flatten(2).transpose(1, 2)
        b = x.shape[0]
        cls = self.f32(e + "class_embedding").expand(b, 1, vd)
        x = torch.cat([cls, x], 1) + self.f32(e + "position_embedding.weight")
        x = self.layer_norm(x, VT + "pre_layrnorm")
        blocks, proj = lora if lora is not None else (None, None)
        n_active = v["num_hidden_layers"] + v["mm_vision_select_layer"] + 1
        for i in range(n_active):
            entries = None if blocks is None else blocks[i]
            if torch.is_grad_enabled():
                x = checkpoint(self.clip_block, i, x, entries, scaling,
                               use_reentrant=False)
            else:
                x = self.clip_block(i, x, entries, scaling)
        x = x[:, 1:]

        def pj(t, n, name):
            y = t @ self.f32(PJ + name + ".weight").t()
            if proj is not None:
                e_ = proj[n]
                y = y + (t @ e_["a"].float().t()) @ e_["b"].float().t() \
                    * scaling
            return y + self.f32(PJ + name + ".bias")

        return pj(F.gelu(pj(x, "fc1", "linear_1")), "fc2", "linear_2")

    def layer_norm(self, x, name):
        eps = float(self.cfg["vision"]["layer_norm_eps"])
        return F.layer_norm(x, x.shape[-1:], self.f32(name + ".weight"),
                            self.f32(name + ".bias"), eps)

    def clip_block(self, i, x, entries, scaling):
        v = self.cfg["vision"]
        vd, nh = v["hidden_size"], v["num_attention_heads"]
        lp = f"{VT}encoder.layers.{i}."
        b, s, _ = x.shape

        def lin(t, ours, hf):
            entry = None if entries is None else entries[ours]
            return self.block_linear(t, lp + hf + ".weight", entry, scaling) \
                + self.f32(lp + hf + ".bias")

        h = self.layer_norm(x, lp + "layer_norm1")
        q, k, val = (lin(h, n, f"self_attn.{n[1]}_proj").view(
            b, s, nh, vd // nh) for n in ("wq", "wk", "wv"))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(vd // nh)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(att, -1), val)
        x = x + lin(o.reshape(b, s, vd), "wo", "self_attn.out_proj")
        h = lin(self.layer_norm(x, lp + "layer_norm2"), "fc1", "mlp.fc1")
        return x + lin(h * torch.sigmoid(1.702 * h), "fc2", "mlp.fc2")

    # -- decoder ------------------------------------------------------------

    def embed(self, ids):
        return self.w[LM + "embed_tokens.weight"][ids.clamp(min=0)].float()

    def prefix(self, queries, query_mask, feats, labels=None):
        """Splice ``feats`` [B, P, D] at each row's image token ->
        (embeds [B, S, D], mask [B, S], positions [B, S]), and with
        ``labels`` [B, L] also the spliced labels (ignored on the
        patches)."""
        rows, masks, labs = [], [], []
        text = self.embed(queries)
        p = feats.shape[1]
        for b in range(queries.shape[0]):
            q = int((queries[b] == IMAGE_TOKEN).nonzero()[0, 0])
            rows.append(torch.cat([text[b, :q], feats[b], text[b, q + 1:]]))
            ones = torch.ones(p, dtype=query_mask.dtype,
                              device=query_mask.device)
            masks.append(torch.cat([query_mask[b, :q], ones,
                                    query_mask[b, q + 1:]]))
            if labels is not None:
                ign = torch.full((p,), IGNORE, dtype=labels.dtype,
                                 device=labels.device)
                labs.append(torch.cat([labels[b, :q], ign, labels[b, q + 1:]]))
        mask = torch.stack(masks).long()
        out = (torch.stack(rows), mask, (mask.cumsum(1) - 1).clamp(min=0))
        return out if labels is None else out + (torch.stack(labs),)

    def _lin(self, i, lora_layer, scaling):
        lp = f"{LM}layers.{i}."

        def lin(x, name):
            entry = None if lora_layer is None else lora_layer[name]
            return self.block_linear(x, f"{lp}{DEC[name]}.weight", entry,
                                     scaling)
        return lin

    def _qkv(self, i, lin, x, pos):
        h = self.rms(x, f"{LM}layers.{i}.input_layernorm.weight")
        q, k, v = (lin(h, nm).view(*x.shape[:2], self.h, self.hd)
                   for nm in ("wq", "wk", "wv"))
        return self.rope(q, pos), self.rope(k, pos), v

    def _finish(self, i, lin, x, o):
        x = x + lin(o.reshape(*x.shape[:2], self.d), "wo")
        h = self.rms(x, f"{LM}layers.{i}.post_attention_layernorm.weight")
        return x + lin(F.silu(lin(h, "w_gate")) * lin(h, "w_up"), "w_down")

    def layer(self, i, xp, xr, masks, lora_layer, scaling):
        """One decoder layer over the prefixes xp [B, Sp, D] and the
        responses xr [B*K, Sr, D] (row b*K + t), each response attending to
        its example's prefix and causally to itself."""
        pmask, rmask, ppos, rpos = masks
        b, sp, _ = xp.shape
        n, sr, _ = xr.shape
        k = n // b
        lin = self._lin(i, lora_layer, scaling)
        qp, kp, vp = self._qkv(i, lin, xp, ppos)
        qr, kr, vr = self._qkv(i, lin, xr, rpos)
        causal_p = torch.ones(sp, sp, dtype=torch.bool,
                              device=xp.device).tril()
        op = self.attend(qp, kp, vp, causal_p[None] & (pmask[:, None] > 0))
        causal_r = torch.ones(sr, sr, dtype=torch.bool,
                              device=xp.device).tril()
        allowed = torch.cat([
            (pmask > 0).repeat_interleave(k, 0)[:, None, :].expand(n, sr, sp),
            causal_r[None] & (rmask[:, None] > 0)], dim=2)
        orr = self.attend(qr, torch.cat([kp.repeat_interleave(k, 0), kr], 1),
                          torch.cat([vp.repeat_interleave(k, 0), vr], 1),
                          allowed)
        return self._finish(i, lin, xp, op), self._finish(i, lin, xr, orr)

    def layer_full(self, i, x, mask, pos, lora_layer, scaling):
        """One decoder layer over whole sequences x [B, S, D], causal over
        the valid keys."""
        s = x.shape[1]
        lin = self._lin(i, lora_layer, scaling)
        q, k, v = self._qkv(i, lin, x, pos)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        return self._finish(i, lin, x, self.attend(
            q, k, v, causal[None] & (mask[:, None] > 0)))

    def sft_logprobs(self, ids, mask, labels, feats, lora, scaling: float,
                     rows: int = 1024):
        """(log-probs of each labelled next token, flat) over the spliced
        sequences: position t scored against label t + 1."""
        x, kmask, pos, sp_labels = self.prefix(ids, mask, feats, labels)
        for i in range(self.cfg["num_hidden_layers"]):
            ll = None if lora is None else lora[i]
            if torch.is_grad_enabled():
                x = checkpoint(self.layer_full, i, x, kmask, pos, ll, scaling,
                               use_reentrant=False)
            else:
                x = self.layer_full(i, x, kmask, pos, ll, scaling)
        h = self.rms(x, LM + "norm.weight")[:, :-1]
        target = sp_labels[:, 1:]
        keep = target != IGNORE
        hid, lab = h[keep], target[keep]
        out = []
        for s in range(0, hid.shape[0], rows):
            args = (hid[s:s + rows], lab[s:s + rows], 1.0)
            out.append(checkpoint(self._head_logprobs, *args,
                                  use_reentrant=False)
                       if torch.is_grad_enabled()
                       else self._head_logprobs(*args))
        return torch.cat(out)

    def response_logprobs(self, queries, query_mask, feats, responses,
                          response_masks, lora, scaling: float,
                          temperature: float = 1.0, rows: int = 1024):
        """Per-token log-probs [B, K, R] of K responses per example after
        the (query + image) prefix, zero at pad positions; ``lora`` a list
        of per-layer entries or None."""
        xp, pmask, ppos = self.prefix(queries, query_mask, feats)
        b = queries.shape[0]
        ids = torch.stack(responses, 1).flatten(0, 1)            # [B*K, R]
        rmask = torch.stack(response_masks, 1).flatten(0, 1).long()
        k = len(responses)
        valid = pmask.sum(1).repeat_interleave(k)
        rpos = (valid[:, None] + rmask.cumsum(1) - 1).clamp(min=0)
        xr = self.embed(ids)
        masks = (pmask, rmask, ppos, rpos)
        for i in range(self.cfg["num_hidden_layers"]):
            ll = None if lora is None else lora[i]
            if torch.is_grad_enabled():
                xp, xr = checkpoint(self.layer, i, xp, xr, masks, ll, scaling,
                                    use_reentrant=False)
            else:
                xp, xr = self.layer(i, xp, xr, masks, ll, scaling)
        norm = LM + "norm.weight"
        hp, hr = self.rms(xp, norm), self.rms(xr, norm)
        hid = torch.cat([hp[:, -1:].repeat_interleave(k, 0), hr[:, :-1]], 1)
        hid = hid.flatten(0, 1)
        labels = ids.flatten()
        out = []
        for s in range(0, hid.shape[0], rows):
            args = (hid[s:s + rows], labels[s:s + rows], temperature)
            out.append(checkpoint(self._head_logprobs, *args,
                                  use_reentrant=False)
                       if torch.is_grad_enabled()
                       else self._head_logprobs(*args))
        lp = torch.cat(out).view(b * k, -1) * rmask
        return lp.view(b, k, -1)

    def _head_logprobs(self, h, labels, temperature):
        logits = h @ self.f32("lm_head.weight").t() / temperature
        return torch.log_softmax(logits, -1).gather(
            1, labels.clamp(min=0)[:, None])[:, 0]
