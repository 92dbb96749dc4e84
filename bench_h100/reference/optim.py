"""AdamW as optax's ``adamw`` computes it, after a global-norm clip: the
update of the adapters in every training cell's reference."""

from __future__ import annotations

import math

import torch


class AdamW:
    """Global-norm clip, then AdamW without weight decay on a cosine
    schedule without warm-up (optax's ``adamw`` with eps outside the root)."""

    def __init__(self, params: list, tp: dict):
        self.p = params
        self.tp = tp
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def lr(self) -> float:
        frac = min(self.count, self.tp["total_steps"]) / self.tp["total_steps"]
        return self.tp["learning_rate"] * 0.5 * (1 + math.cos(math.pi * frac))

    @torch.no_grad()
    def step(self, grads: list) -> list:
        """Apply ``grads`` -> the gradients as clipped."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        cap = self.tp["max_grad_norm"]
        if float(norm) >= cap:
            grads = [g * (cap / norm) for g in grads]
        lr = self.lr()
        self.count += 1
        c1, c2 = 1 - 0.9 ** self.count, 1 - 0.999 ** self.count
        for p, g, mu, nu in zip(self.p, grads, self.mu, self.nu):
            mu.mul_(0.9).add_(0.1 * g)
            nu.mul_(0.999).add_(0.001 * g * g)
            p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + 1e-8))
        return grads
