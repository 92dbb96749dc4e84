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

Over a mesh (``parallel/mesh.Mesh``) the update is the JAX program's on
the global batch:

- the gradients are averaged over the data group once per update, after
  the last micro-step (each rank accumulates its own first);
- the global norm counts a leaf split over the model group once per
  shard (their sums of squares added over the group) and a replicated
  leaf once;
- ZeRO-1: each data rank keeps ``mu`` and ``nu`` only for its part of
  each leaf (``parallel/sharding.zero1_slice``), updates only that part of
  the parameter and the parts are joined by a zero-padded ``all_reduce``
  over the data group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

from opadpo_torch.models.lora import named_leaves
from opadpo_torch.parallel import comm
from opadpo_torch.parallel.sharding import model_sharded_flags, zero1_slice
from opadpo_torch.utils import trace


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


def global_norm(tensors, sharded=None, tp=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in f32.  With a model
    group ``tp``, the tensors flagged in ``sharded`` are slices whose sums
    of squares are added over the group; the others are whole on every
    rank and count once."""
    tensors = list(tensors)
    if tp is None or not any(sharded or ()):
        return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))
    rep = sum(torch.sum(t.float() ** 2)
              for t, s in zip(tensors, sharded) if not s)
    part = sum(torch.sum(t.float() ** 2)
               for t, s in zip(tensors, sharded) if s)
    return torch.sqrt(rep + comm.all_reduce_(part.reshape(1), tp)[0])


@dataclasses.dataclass
class TrainState:
    """The trainable adapter tree and the optimizer's state.  Over a mesh,
    ``params`` is this rank's shard of the adapter, ``mu`` / ``nu`` hold
    its ZeRO-1 parts (``parts``: ``(axis, start, length)`` of each leaf, or
    None where the moment is whole) and ``sharded`` flags the leaves split
    over the model group."""

    params: dict
    mu: list
    nu: list
    acc: Optional[list]
    count: int = 0            # AdamW updates applied (optax's count)
    mini_step: int = 0        # micro-steps accumulated towards the next
    step: int = 0             # train steps taken
    parts: Optional[list] = None
    sharded: Optional[list] = None

    @staticmethod
    def create(params: dict, cfg: OptimizerConfig,
               mesh=None) -> "TrainState":
        leaves = [t for _, t in named_leaves(params)]
        n_data = 1 if mesh is None else mesh.data
        d = 0 if mesh is None else mesh.data_rank
        parts = [zero1_slice(t.shape, n_data, d) for t in leaves]
        zeros = [torch.zeros_like(t if p is None else t.narrow(*p))
                 for t, p in zip(leaves, parts)]
        acc = None
        if cfg.grad_accum_steps > 1:
            acc = [torch.zeros_like(t) for t in leaves]
        sharded = (model_sharded_flags(params)
                   if mesh is not None and mesh.model > 1
                   else [False] * len(leaves))
        return TrainState(params=params, mu=zeros,
                          nu=[z.clone() for z in zeros], acc=acc,
                          parts=parts, sharded=sharded)


class AdamW:
    """Global-norm clip, then AdamW on the schedule, optionally averaged
    over ``grad_accum_steps`` micro-steps, over ``mesh`` when given (see
    the module docstring).  ``last_grad_norm``: the ``loss/grad_norm``
    stat of the last ``apply_gradients``: the global norm of the gradient
    its update applied (after the data group's mean), or, when micro-steps
    accumulate, of that micro-step's gradient as this rank holds it."""

    def __init__(self, cfg: OptimizerConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.schedule = make_schedule(cfg)
        self.last_grad_norm: Optional[torch.Tensor] = None

    def _grad_norm(self, state: TrainState, grads: list) -> torch.Tensor:
        tp = None if self.mesh is None else self.mesh.tp
        return global_norm(grads, state.sharded, tp)

    @torch.no_grad()
    def apply_gradients(self, state: TrainState, grads: list) -> TrainState:
        """The update, in place -> ``state``; the span ``adamw.apply``."""
        with trace.span("adamw.apply"):
            return self._apply(state, grads)

    def _apply(self, state: TrainState, grads: list) -> TrainState:
        cfg = self.cfg
        named = named_leaves(state.params)
        params = [t for _, t in named]
        parts = state.parts or [None] * len(params)
        state.step += 1
        if cfg.grad_accum_steps > 1:
            n = state.mini_step
            self.last_grad_norm = self._grad_norm(state, grads)
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (n + 1))
            if n + 1 < cfg.grad_accum_steps:
                state.mini_step = n + 1
                return state
            grads, state.mini_step = [a.clone() for a in state.acc], 0
            for a in state.acc:
                a.zero_()
        if self.mesh is not None:
            grads = comm.all_reduce_flat(grads, self.mesh.data_group,
                                         mean=True)
        g_norm = self._grad_norm(state, grads)
        if cfg.grad_accum_steps == 1:
            self.last_grad_norm = g_norm
        if cfg.max_grad_norm is not None:
            trace.count("host_syncs")
            if not bool(g_norm < cfg.max_grad_norm):
                grads = [g / g_norm.to(g.dtype) * cfg.max_grad_norm
                         for g in grads]
        count = state.count + 1
        c1 = 1.0 - cfg.b1 ** count
        c2 = 1.0 - cfg.b2 ** count
        lr = self.schedule(state.count)
        masks = decay_mask(named) if cfg.weight_decay else [False] * len(named)
        for p, g, mu, nu, m, part in zip(params, grads, state.mu, state.nu,
                                         masks, parts):
            if part is not None:
                p, g = p.narrow(*part), g.narrow(*part)
            mu.copy_((1 - cfg.b1) * g + cfg.b1 * mu)
            nu.copy_((1 - cfg.b2) * (g * g) + cfg.b2 * nu)
            upd = (mu / torch.tensor(c1, dtype=mu.dtype)) / (
                torch.sqrt(nu / torch.tensor(c2, dtype=nu.dtype)) + cfg.eps)
            if m:
                upd = upd + cfg.weight_decay * p
            p.copy_(p + (-lr) * upd)
        if any(part is not None for part in parts):
            join_zero1(params, parts, self.mesh.data_group)
        state.count = count
        return state


def _zero_padded(t: torch.Tensor, part) -> torch.Tensor:
    buf = torch.zeros_like(t)
    buf.narrow(*part).copy_(t.narrow(*part))
    return buf


@torch.no_grad()
def join_zero1(tensors: list, parts: list, group) -> None:
    """Each ZeRO-1-split tensor made whole on every data rank, in place,
    from the parts the ranks hold: one zero-padded ``all_reduce``."""
    idx = [i for i, p in enumerate(parts) if p is not None]
    joined = comm.all_reduce_flat(
        [_zero_padded(tensors[i], parts[i]) for i in idx], group)
    for i, t in zip(idx, joined):
        tensors[i].copy_(t)


@torch.no_grad()
def whole_moments(moments: list, params: list, parts: list,
                  group) -> list:
    """ZeRO-1 moments as whole tensors in their leaves' shapes: each part
    placed in zeros and the parts added over the data group."""
    out = []
    for m, p, part in zip(moments, params, parts):
        if part is None:
            out.append(m.clone())
            continue
        buf = torch.zeros(p.shape, dtype=m.dtype, device=m.device)
        buf.narrow(*part).copy_(m)
        out.append(buf)
    idx = [i for i, p in enumerate(parts) if p is not None]
    joined = comm.all_reduce_flat([out[i] for i in idx], group)
    for i, t in zip(idx, joined):
        out[i] = t
    return out
