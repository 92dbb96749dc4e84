"""Rotary position embeddings (LLaMA flavour), port of
``opadpo_tpu/ops/rope.py``.

Pairs are ``(x[..., :d/2], x[..., d/2:])`` rotated by ``theta_i =
base^(-2i/d)``; positions are given per row so left-padded batches work
(``position_ids = cumsum(mask) - 1``).  cos and sin are f32 and gathered
at each row's positions.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_len: int, base: float = 10000.0,
                     device: str | torch.device = "cpu"):
    """cos/sin tables [max_len, head_dim], f32."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos_table: torch.Tensor,
               sin_table: torch.Tensor, positions: torch.Tensor):
    """q, k: [B, S, H, D]; positions: [B, S] int; tables [max_len, D].

    ``x*cos + rotate_half(x)*sin`` in f32, cast back to the input dtype."""
    half = q.shape[-1] // 2
    cos_h = cos_table[positions][:, :, None, :half]
    sin_h = sin_table[positions][:, :, None, :half]

    def rot(x):
        x32 = x.float()
        x1, x2 = x32[..., :half], x32[..., half:]
        return torch.cat([x1 * cos_h - x2 * sin_h,
                          x2 * cos_h + x1 * sin_h], dim=-1).to(x.dtype)

    return rot(q), rot(k)
