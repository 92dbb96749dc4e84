"""LoRA on plain (unquantized) weights: port of ``opadpo_tpu/models/lora.py``.

An adapter is a nested dict of ``{"a": [r, in], "b": [out, r]}`` entries
mirroring the model's module names, kept apart from the base weights so
one base serves any adapter (the JAX design).  The factors are stored in
torch's ``Linear`` layout: ``x @ A @ B`` in JAX is
``F.linear(F.linear(x, a), b)`` here.

``y = x W^T + (x A^T) B^T * (alpha / r)``, with the delta accumulated in f32
and added to the base product in f32 before the cast back to x's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Reference defaults: OPA r=256 alpha=512; DPO inherits them."""

    rank: int = 64
    alpha: float = 128.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def tree_get(tree: Optional[dict], *path) -> Optional[dict]:
    """Walk a possibly-None adapter tree; None if any key is missing."""
    node = tree
    for p in path:
        if node is None:
            return None
        if isinstance(node, (list, tuple)):
            node = node[p]
        elif p in node:
            node = node[p]
        else:
            return None
    return node


def lora_delta(x: torch.Tensor, entry: Optional[dict],
               scaling: float) -> Optional[torch.Tensor]:
    """f32 delta ``((x A) cast to B's dtype) B * scaling``, or None."""
    if entry is None:
        return None
    xa = F.linear(x.float(), entry["a"].float()).to(entry["b"].dtype)
    return F.linear(xa.float(), entry["b"].float()) * scaling


def lora_dense(x: torch.Tensor, weight: torch.Tensor,
               entry: Optional[dict] = None,
               scaling: float = 1.0) -> torch.Tensor:
    """Dense ``[.., in] -> [.., out]`` with an optional LoRA delta.

    ``weight`` is ``[out, in]``.  The base product runs in x's dtype; with
    an adapter it is widened to f32 for the sum."""
    y = F.linear(x, weight)
    delta = lora_delta(x, entry, scaling)
    if delta is None:
        return y
    return (y.float() + delta).to(x.dtype)
