"""The collectives that XLA inserts for the JAX package's mesh, written out
for ``torch.distributed``.

Only ``all_reduce`` and ``broadcast`` are used: they are what gloo
carries for CUDA tensors as well as NCCL, so two ranks can share one card
over gloo.  A gather is an ``all_reduce`` into a buffer that is zero
outside each rank's slice (``gather``).

- ``copy_to_model`` / ``reduce_from_model``: the Megatron pair.  The copy
  into the model region is the identity forward and sums the gradient
  over the model group backward; the reduce out of it sums the partial
  outputs of a row-parallel layer forward and is the identity backward.
- ``all_reduce_flat``: one ``all_reduce`` over a list of tensors,
  flattened into one buffer per dtype (the data group's gradient mean).
- ``global_stats``: ratios whose numerators and denominators are summed
  over the data group first (a stat over the global batch).

Each collective adds one to ``COUNTS[name]`` and its payload to
``BYTES[name]`` when it runs (a group of one runs none), as the kernels
count their launches.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from opadpo_torch.parallel.mesh import Group

COUNTS: Counter = Counter()
BYTES: Counter = Counter()


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()


def counts() -> dict:
    """``{name: {"calls": n, "bytes": b}}`` of the collectives run since
    the last ``reset_counts``."""
    return {k: {"calls": COUNTS[k], "bytes": BYTES[k]} for k in sorted(COUNTS)}


def _active(group: Optional[Group]) -> bool:
    return group is not None and group.pg is not None


def all_reduce_(t: torch.Tensor, group: Optional[Group],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over ``group`` (nothing for a
    group of one); returns ``t``."""
    if _active(group):
        COUNTS["all_reduce"] += 1
        BYTES["all_reduce"] += t.numel() * t.element_size()
        dist.all_reduce(t, op=op, group=group.pg)
    return t


def broadcast_(t: torch.Tensor, group: Optional[Group],
               src: int = 0) -> torch.Tensor:
    """In-place ``broadcast`` of ``t`` from the group's rank ``src``."""
    if _active(group):
        COUNTS["broadcast"] += 1
        BYTES["broadcast"] += t.numel() * t.element_size()
        dist.broadcast(t, src=group.global_rank(src), group=group.pg)
    return t


def barrier(group: Optional[Group]) -> None:
    """Wait for every rank of ``group``: an ``all_reduce`` of one
    element."""
    if _active(group):
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(group.pg) == "nccl" else torch.device("cpu")
        all_reduce_(torch.zeros(1, device=dev), group)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward (the
    input of a column-parallel layer, or a replicated factor whose
    gradient each rank holds only part of)."""
    if not _active(group):
        return x
    return _CopyToRegion.apply(x, group)


def reduce_from_model(x: torch.Tensor,
                      group: Optional[Group]) -> torch.Tensor:
    """The partial sums of ``group``'s ranks added forward; the identity
    backward (the output of a row-parallel layer)."""
    if not _active(group):
        return x
    return _ReduceFromRegion.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= group.size
        buf = x.new_zeros(shape)
        buf.narrow(dim, group.rank * ctx.n, ctx.n).copy_(x)
        return all_reduce_(buf, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n), None, None


def gather(x: torch.Tensor, group: Optional[Group],
           dim: int = -1) -> torch.Tensor:
    """The equal slices of ``group``'s ranks along ``dim`` joined in rank
    order: a zero-padded ``all_reduce`` (the gradient is this rank's slice
    of the output's)."""
    if not _active(group):
        return x
    return _Gather.apply(x, group, dim % x.dim())


def all_reduce_flat(tensors: Sequence[torch.Tensor], group: Optional[Group],
                    mean: bool = False) -> List[torch.Tensor]:
    """The tensors summed (or averaged, ``mean``) over ``group``: one
    ``all_reduce`` per dtype over their flattened concatenation.  Returns
    new tensors in the given shapes."""
    tensors = list(tensors)
    if not _active(group):
        return [t.clone() for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce_(flat, group)
        if mean:
            flat = flat / group.size
        start = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[start:start + n].view_as(tensors[i])
            start += n
    return out


def global_stats(parts: dict, mesh) -> dict:
    """``{name: (numerator, denominator)}`` -> ``{name: numerator /
    denominator}``, both summed over ``mesh``'s data group first (one
    ``all_reduce``; none without a mesh), detached."""
    names = list(parts)
    nd = torch.stack([torch.stack([parts[k][0].detach().float(),
                                   parts[k][1].detach().float()])
                      for k in names])
    if mesh is not None:
        nd = all_reduce_(nd, mesh.data_group)
    return {k: nd[i, 0] / torch.clamp(nd[i, 1], min=1e-9)
            for i, k in enumerate(names)}
