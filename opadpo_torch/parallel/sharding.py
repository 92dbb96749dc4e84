"""Which part of each weight, adapter factor and optimizer moment a rank
holds: port of ``opadpo_tpu/parallel/sharding.py``.

Tensor parallelism over the model group (``_TP_RULES``, the JAX table by
name; torch ``Linear`` weights are ``[out, in]``, so a JAX column split of
``[in, out]`` is a split of dim 0 here):

- ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``: column-parallel, each rank
  holds ``out / model`` rows (its heads, its slice of the MLP's width);
- ``wo``, ``w_down``: row-parallel, each rank holds ``in / model``
  columns; their products are partial sums (``models/llama.py`` adds them
  over the model group);
- ``lm_head``: split over the vocabulary (column-parallel);
- ``embed``, the norms, the vision tower and the projector: replicated.
  The JAX rules also match CLIP's ``wq`` / ``wk`` / ``wv`` / ``wo``; the
  port keeps the tower (0.3 B parameters) whole on every rank.

Quantized leaves follow the weight they quantize: int8 ``q`` ``[N, K]``
takes the weight's split and its per-N ``scale`` is sliced only under a
column split (under a row split it stays whole: it is a maximum over all
of K, so the whole weight is quantized before it is split); int4 ``q``
``[N, K/2]`` and the group scale ``[N, K/128]`` take the weight's split,
and a row split must put whole groups of 128 in each shard.  LoRA follows
the same rules: ``a`` ``[r, in]`` is replicated; ``b`` ``[out, r]`` is split
on ``out`` only when the base weight is column-parallel.

ZeRO-1 (``zero1_axis``): each optimizer moment is split over the data
group along its largest axis that ``n_data`` divides, and replicated when
no axis divides or ``n_data`` is 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from opadpo_torch.models.lora import named_leaves
from opadpo_torch.ops.quant import GROUP, QuantLinear
from opadpo_torch.parallel import comm

COLUMN, ROW = "column", "row"
_TP_RULES = (
    ("wq", COLUMN), ("wk", COLUMN), ("wv", COLUMN), ("wo", ROW),
    ("w_gate", COLUMN), ("w_up", COLUMN), ("w_down", ROW),
    ("embed", None), ("lm_head", COLUMN),
)
_RULES = dict(_TP_RULES)


def split_of(name: str) -> Optional[str]:
    """``"column"``, ``"row"`` or None (replicated) for a decoder weight
    name."""
    return _RULES.get(name)


def _slice(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways")
    step = size // n
    # a copy, even where the slice is contiguous: a view would keep the
    # whole tensor's storage alive on every rank
    return t.narrow(dim, rank * step, step).clone(
        memory_format=torch.contiguous_format)


def shard_weight(w: torch.Tensor, split: Optional[str], rank: int,
                 n: int) -> torch.Tensor:
    """This rank's part of a ``[out, in]`` weight."""
    if split is None or n == 1:
        return w
    return _slice(w, 0 if split == COLUMN else 1, rank, n)


def shard_quant(lin: QuantLinear, split: Optional[str], rank: int,
                n: int) -> QuantLinear:
    """This rank's part of a quantized weight (see the module
    docstring)."""
    if split is None or n == 1:
        return lin
    if split == COLUMN:
        q, scale = _slice(lin.q, 0, rank, n), _slice(lin.scale, 0, rank, n)
    elif lin.bits == 8:
        q, scale = _slice(lin.q, 1, rank, n), lin.scale
    else:
        k_local = lin.in_features // n
        if lin.in_features % n or k_local % GROUP:
            raise ValueError(
                f"int4 row split of K {lin.in_features} over {n} ranks: "
                f"each shard must hold whole groups of {GROUP}")
        q, scale = _slice(lin.q, 1, rank, n), _slice(lin.scale, 1, rank, n)
    return QuantLinear(q, scale, lin.bits, lin.bias, lin.mode)


def model_sharded(path: str) -> bool:
    """Whether the model group holds an adapter leaf in slices, from its
    ``named_leaves`` path (``/llama/layers/3/wq/b``): the ``b`` of a
    column-parallel decoder weight, rather than whole on every rank (the
    vision tower's and the projector's entries are never split)."""
    parts = path.strip("/").split("/")
    return (parts[0] == "llama" and len(parts) >= 2 and parts[-1] == "b"
            and split_of(parts[-2]) == COLUMN)


def local_llama_config(cfg, n: int):
    """The decoder configuration one model rank runs: its heads and its
    slice of the MLP's width (the vocabulary size stays the logits' full
    width)."""
    for name, value in (("num_heads", cfg.num_heads),
                        ("num_kv_heads", cfg.num_kv_heads),
                        ("intermediate_size", cfg.intermediate_size)):
        if value % n:
            raise ValueError(f"{name} {value} does not split {n} ways")
    if cfg.vocab_size % n:
        raise ValueError(f"vocab_size {cfg.vocab_size} does not split {n} "
                         "ways")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // n, num_kv_heads=cfg.num_kv_heads // n,
        intermediate_size=cfg.intermediate_size // n)


def shard_linear(owner: nn.Module, name: str, rank: int, n: int) -> None:
    """``owner.<name>`` (an ``nn.Linear`` or a ``QuantLinear``) cut to
    this rank's shard by its name's rule, in place."""
    lin = getattr(owner, name)
    split = split_of(name)
    if isinstance(lin, QuantLinear):
        setattr(owner, name, shard_quant(lin, split, rank, n))
        return
    w = shard_weight(lin.weight.data, split, rank, n)
    lin.weight = nn.Parameter(w, requires_grad=False)
    lin.out_features, lin.in_features = w.shape


def shard_layer(layer: nn.Module, rank: int, n: int) -> nn.Module:
    """One decoder layer cut to this rank's shard, in place."""
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        shard_linear(layer, name, rank, n)
    return layer


@torch.no_grad()
def shard_module(model: nn.Module, mesh, weights_done: bool = False
                 ) -> nn.Module:
    """A whole ``Llava`` turned into this rank's shard, in place: the
    decoder's layers and the lm_head (unless ``weights_done``: set-up cut
    each as it was made), the decoder's configuration made local, and the
    mesh recorded (``model.mesh``; ``model.llama.tp`` and each layer's
    ``tp``, the model group when tensor parallelism is on)."""
    lm = model.llama
    n, rank = mesh.model, mesh.model_rank
    if n > 1:
        if not weights_done:
            for layer in lm.layers:
                shard_layer(layer, rank, n)
            shard_linear(lm, "lm_head", rank, n)
        lm.cfg = local_llama_config(lm.cfg, n)
    lm.tp = mesh.tp
    for layer in lm.layers:
        layer.tp = mesh.tp
    model.mesh = mesh
    return model


def shard_lora(lora: Optional[dict], mesh) -> Optional[dict]:
    """This rank's part of an adapter tree (a new tree sharing the
    unsplit leaves)."""
    if lora is None or mesh.model == 1:
        return lora
    n, rank = mesh.model, mesh.model_rank

    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            return (_slice(node, 0, rank, n) if model_sharded(prefix)
                    else node)
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}
        return [walk(v, f"{prefix}/{i}") for i, v in enumerate(node)]

    return walk(lora, "")


@torch.no_grad()
def unshard_lora(lora: dict, mesh) -> dict:
    """The whole adapter on every rank of the model group: each split
    ``b`` gathered (a zero-padded ``all_reduce``), the rest detached."""
    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            node = node.detach()
            if mesh.model > 1 and model_sharded(prefix):
                return comm.gather(node, mesh.model_group, dim=0)
            return node
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}
        return [walk(v, f"{prefix}/{i}") for i, v in enumerate(node)]

    return walk(lora, "")


def model_sharded_flags(params: dict) -> list:
    """``model_sharded`` of each leaf of an adapter tree, in
    ``named_leaves`` order."""
    return [model_sharded(path) for path, _ in named_leaves(params)]


def zero1_axis(shape: Tuple[int, ...], n_data: int) -> Optional[int]:
    """The axis ZeRO-1 splits a moment of ``shape`` along over ``n_data``
    ranks: the largest that ``n_data`` divides (the first of equals), or
    None (replicated) when none does or ``n_data`` is 1."""
    if not shape or n_data == 1:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % n_data == 0 and (best is None or d > shape[best]):
            best = i
    return best


def zero1_slice(shape, n_data: int, data_rank: int):
    """``(axis, start, length)`` of a data rank's part of a moment, or
    None when the moment is replicated."""
    axis = zero1_axis(tuple(shape), n_data)
    if axis is None:
        return None
    step = shape[axis] // n_data
    return axis, data_rank * step, step
