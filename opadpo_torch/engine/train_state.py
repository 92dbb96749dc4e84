"""Train state and optimizer: port of ``opadpo_tpu/engine/train_state.py``.

The JAX package chains optax's ``clip_by_global_norm`` and ``adamw`` on a
warmup + cosine/linear/constant schedule, wrapped in ``MultiSteps`` when
gradients are accumulated.  This module writes the same update by hand,
step for step as optax computes it:

- the schedule is ``join_schedules([linear(0 -> lr, max(warmup, 1)),
  decay], [warmup])``, read at the number of updates applied so far, so
  the first update of a warmup runs at lr 0;
- the global-norm clip runs before AdamW: ``g * max_norm / |g|`` when
  ``|g| >= max_norm``;
- AdamW keeps its moments in the parameter dtype, corrects both for bias,
  puts eps outside the square root, and adds weight decay only where
  ``decay_mask`` says so, before the learning rate;
- with ``grad_accum_steps = k`` the gradients of k micro-steps are
  averaged (running mean) and applied on the k-th; the other micro-steps
  leave the parameters and the optimizer untouched.

Unlike optax, the parameters are updated in place (they are the adapter's
leaves, which the train step differentiates).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

from opadpo_torch.models.lora import named_leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-6
    lr_scheduler_type: str = "cosine"    # "cosine" | "constant" | "linear"
    warmup_steps: int = 5
    total_steps: int = 500
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_accum_steps: int = 1


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate at update count ``n`` (optax's join of a linear warmup
    from 0 and a cosine, linear or constant decay)."""
    lr = cfg.learning_rate
    warm = max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)

    def decay(n: int) -> float:
        frac = min(max(n, 0), decay_steps) / decay_steps
        if cfg.lr_scheduler_type == "cosine":
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        if cfg.lr_scheduler_type == "linear":
            return lr * (1.0 - frac)
        return lr

    def schedule(n: int) -> float:
        if n < cfg.warmup_steps:
            return lr * min(max(n, 0), warm) / warm
        return decay(n - cfg.warmup_steps)

    return schedule


_NO_DECAY_MARKERS = ("norm", "bias", "ln1", "ln2", "ln_")


def decay_mask(named_params) -> List[bool]:
    """True where weight decay applies, for ``(name, tensor)`` pairs: not
    on a leaf whose name mentions a norm or bias marker, nor on any leaf of
    rank < 2 (the reference's AdamW parameter groups)."""
    return [not any(m in name.lower() for m in _NO_DECAY_MARKERS)
            and t.dim() >= 2 for name, t in named_params]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


@dataclasses.dataclass
class TrainState:
    """The trainable adapter tree and the optimizer's state."""

    params: dict
    mu: list
    nu: list
    acc: Optional[list]
    count: int = 0            # AdamW updates applied (optax's count)
    mini_step: int = 0        # micro-steps accumulated towards the next
    step: int = 0             # train steps taken

    @staticmethod
    def create(params: dict, cfg: OptimizerConfig) -> "TrainState":
        leaves = [t for _, t in named_leaves(params)]
        zeros = [torch.zeros_like(t) for t in leaves]
        acc = None
        if cfg.grad_accum_steps > 1:
            acc = [torch.zeros_like(t) for t in leaves]
        return TrainState(params=params, mu=zeros,
                          nu=[z.clone() for z in zeros], acc=acc)


class AdamW:
    """Global-norm clip, then AdamW on the schedule, optionally averaged
    over ``grad_accum_steps`` micro-steps (see the module docstring)."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    @torch.no_grad()
    def apply_gradients(self, state: TrainState, grads: list) -> TrainState:
        cfg = self.cfg
        named = named_leaves(state.params)
        params = [t for _, t in named]
        state.step += 1
        if cfg.grad_accum_steps > 1:
            n = state.mini_step
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (n + 1))
            if n + 1 < cfg.grad_accum_steps:
                state.mini_step = n + 1
                return state
            grads, state.mini_step = [a.clone() for a in state.acc], 0
            for a in state.acc:
                a.zero_()
        if cfg.max_grad_norm is not None:
            g_norm = global_norm(grads)
            if not bool(g_norm < cfg.max_grad_norm):
                grads = [g / g_norm.to(g.dtype) * cfg.max_grad_norm
                         for g in grads]
        count = state.count + 1
        c1 = 1.0 - cfg.b1 ** count
        c2 = 1.0 - cfg.b2 ** count
        lr = self.schedule(state.count)
        masks = decay_mask(named) if cfg.weight_decay else [False] * len(named)
        for p, g, mu, nu, m in zip(params, grads, state.mu, state.nu, masks):
            mu.copy_((1 - cfg.b1) * g + cfg.b1 * mu)
            nu.copy_((1 - cfg.b2) * (g * g) + cfg.b2 * nu)
            upd = (mu / torch.tensor(c1, dtype=mu.dtype)) / (
                torch.sqrt(nu / torch.tensor(c2, dtype=nu.dtype)) + cfg.eps)
            if m:
                upd = upd + cfg.weight_decay * p
            p.copy_(p + (-lr) * upd)
        state.count = count
        return state
