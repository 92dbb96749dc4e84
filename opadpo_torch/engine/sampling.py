"""Token sampling (greedy / temperature / top-k / top-p): port of
``opadpo_tpu/engine/sampling.py``.

HF warper semantics: top-p keeps the smallest prefix of the sorted
distribution whose mass reaches ``top_p``, the crossing token included;
with top-k set, top-p and the draw run in the k-wide space.  Draws come
from an explicit ``torch.Generator`` on the logits' device, so they differ
from ``jax.random`` draws: compare sampled output by support and
distribution, greedy output token for token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 1.0
    top_k: int = 0              # 0 = disabled
    top_p: float = 1.0          # 1.0 = disabled
    greedy: bool = False
    # "sort" or "approx": the JAX package's lax.top_k or
    # lax.approx_max_k(recall_target=1.0), the same exact top-k set on its
    # TPU lowering; both run the exact torch.topk here
    topk_impl: str = "sort"
    suppress_eos: bool = False  # reference suppress_tokens=[eos]
    eos_token_id: int = 2
    pad_token_id: int = 0
    max_new_tokens: int = 896

    def __post_init__(self):
        if self.topk_impl not in ("sort", "approx"):
            raise ValueError(f"topk_impl={self.topk_impl!r} "
                             "(expected 'sort' or 'approx')")


def _draw(logits: torch.Tensor, generator: Optional[torch.Generator]):
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_tokens(logits: torch.Tensor, cfg: SamplingConfig,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    logits = logits.float()
    if cfg.suppress_eos:
        logits = logits.clone()
        logits[:, cfg.eos_token_id] = NEG_INF
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)

    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        vals, idx = torch.topk(logits, cfg.top_k, dim=-1)   # sorted desc
        if cfg.top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs) < cfg.top_p
            vals = torch.where(keep, vals, NEG_INF)
        local = _draw(vals, generator)
        return torch.gather(idx, 1, local[:, None])[:, 0]

    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < cfg.top_p
        threshold = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits >= threshold, logits, NEG_INF)
    return _draw(logits, generator)
