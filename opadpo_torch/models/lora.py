"""LoRA over plain or quantized base weights: port of
``opadpo_tpu/models/lora.py``.

An adapter is a nested dict of ``{"a": [r, in], "b": [out, r]}`` entries
mirroring the model's module names (per-layer entries in a ``"layers"``
list), kept apart from the base weights so one base serves any adapter (the
JAX design).  The factors are stored in torch's ``Linear`` layout:
``x @ A @ B`` in JAX is ``F.linear(F.linear(x, a), b)`` here.  Training
differentiates the adapter's leaves (``make_trainable``), never the base.

``y = x W^T + (x A^T) B^T * (alpha / r)``, with the delta accumulated in f32
and added to the base product in f32 before the cast back to x's dtype.
The base may be a frozen int8 / int4 ``QuantLinear`` (the QLoRA
configuration, ``ops/quant.py``): its product comes back in x's dtype and
is widened the same way.

``merge_lora`` folds an adapter into the base weights in place, for export
or serving without the adapter.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from opadpo_torch.ops.quant import QuantLinear


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Reference defaults: OPA r=256 alpha=512; DPO inherits them."""

    rank: int = 64
    alpha: float = 128.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def init_lora_entry(in_dim: int, out_dim: int, cfg: LoraConfig,
                    generator: torch.Generator) -> dict:
    """Kaiming-uniform A in +-sqrt(3 / in_dim), zero B (the PEFT init), in
    the config's dtype, on the generator's device."""
    bound = (1.0 / in_dim) ** 0.5 * 3.0 ** 0.5
    dev = generator.device
    a = torch.rand((cfg.rank, in_dim), generator=generator, device=dev)
    return {"a": ((a * 2.0 - 1.0) * bound).to(cfg.dtype),
            "b": torch.zeros((out_dim, cfg.rank), dtype=cfg.dtype,
                             device=dev)}


def named_leaves(tree, prefix: str = "") -> list:
    """``(path, tensor)`` pairs of an adapter tree in a fixed order (dict
    keys sorted, lists in order), paths like ``/llama/layers/0/wq/a``."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}/{k}")]
    return [x for i, node in enumerate(tree)
            for x in named_leaves(node, f"{prefix}/{i}")]


def tree_map(fn, tree):
    """The adapter tree with ``fn`` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, node) for node in tree]


def make_trainable(tree):
    """A copy of the adapter whose leaves are fresh tensors that require
    gradients (the policy adapter of a train step)."""
    return tree_map(lambda x: x.detach().clone().requires_grad_(True), tree)


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


def lora_dense(x: torch.Tensor, weight, entry: Optional[dict] = None,
               scaling: float = 1.0) -> torch.Tensor:
    """Dense ``[.., in] -> [.., out]`` with an optional LoRA delta.

    ``weight`` is a ``[out, in]`` tensor, an ``nn.Linear`` (its weight; the
    bias is the caller's) or a ``QuantLinear``.  The base product runs in
    x's dtype; with an adapter it is widened to f32 for the sum."""
    if isinstance(weight, QuantLinear):
        y = weight(x)
    else:
        y = F.linear(x, weight.weight if isinstance(weight, nn.Linear)
                     else weight)
    delta = lora_delta(x, entry, scaling)
    if delta is None:
        return y
    return (y.float() + delta).to(x.dtype)


def _merge_targets(module: nn.Module, node, path: str, out: list) -> None:
    """(linear, entry, path) for each adapter entry under ``node``, the
    linear being the submodule of ``module`` at the entry's path."""
    if isinstance(node, dict) and "a" in node and "b" in node:
        out.append((module, node, path))
        return
    items = node.items() if isinstance(node, dict) else enumerate(node)
    for key, sub in items:
        child = module[key] if isinstance(key, int) else getattr(module, key)
        _merge_targets(child, sub, f"{path}/{key}", out)


@torch.no_grad()
def merge_lora(model: nn.Module, lora, scaling: float) -> nn.Module:
    """Fold the adapter into the base weights, in place (a copy of the 7B
    would take another 14 GB; a caller that needs both clones first) ->
    ``model``.

    Each ``[out, in]`` weight with an entry becomes ``W + scaling (B A)``,
    summed in f32 and cast back to W's dtype, as the JAX ``merge_lora``
    does (its entries are ``[in, out]``, the transpose): the decoder, the
    vision tower and the projector alike.  A quantized base
    (``QuantLinear``) under an entry raises, where the JAX function
    returns the quantized leaf unmerged; every entry is checked before any
    weight changes."""
    targets: list = []
    _merge_targets(model, lora if lora is not None else {}, "", targets)
    for lin, entry, path in targets:
        if isinstance(lin, QuantLinear):
            raise ValueError(f"merge_lora: the base at {path} is quantized "
                             f"({lin.bits}-bit); merge into a bf16 or f32 "
                             "base, not a QuantLinear")
        if not isinstance(lin, nn.Linear):
            raise ValueError(f"merge_lora: {path} is a "
                             f"{type(lin).__name__}, not a linear")
        shape = (entry["b"].shape[0], entry["a"].shape[1])
        if tuple(lin.weight.shape) != shape:
            raise ValueError(f"merge_lora: {path} weight "
                             f"{tuple(lin.weight.shape)} against an adapter "
                             f"of {shape}")
    for lin, entry, _ in targets:
        w = lin.weight
        delta = (entry["b"].float() @ entry["a"].float()) * scaling
        w.copy_((w.float() + delta.to(w.device)).to(w.dtype))
    return model
