"""The ``data x model`` process grid: port of ``opadpo_tpu/parallel/mesh.py``.

The JAX package drives one GSPMD program over a ``data x model`` device
mesh and lets XLA insert the collectives.  Here each rank is one process
(``torchrun``, or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) and the collectives
are explicit (``parallel/comm.py``):

- axis ``data``: each data rank takes its rows of the global batch; the
  gradients are averaged over the data group once per optimizer step and
  the AdamW moments are partitioned over it (ZeRO-1);
- axis ``model``: Megatron tensor parallelism of the decoder (attention
  heads, the MLP's hidden width and the vocabulary split over the model
  group, ``parallel/sharding.py``).

Ranks follow the JAX device order, ``np.reshape(devices, (data, model))``:
``rank = data_rank * model + model_rank``, so a model group is a run of
consecutive ranks.  One process with no process group is the mesh
``1 x 1`` and every collective is skipped.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from opadpo_torch.device import resolve_device

@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How to carve the ranks: ``data x model`` must equal the world size;
    ``data`` -1 takes what ``model`` leaves."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        model = self.model
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return MeshConfig(data=data, model=model)


@dataclasses.dataclass(frozen=True)
class Group:
    """One axis of the mesh as this rank sees it: its size, this rank's
    index in it, the global ranks in it (index order) and the process
    group its collectives run on (None: no collective, the group is this
    process alone)."""

    size: int
    rank: int
    ranks: tuple
    pg: object = None

    def global_rank(self, index: int) -> int:
        return self.ranks[index]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The resolved grid, this rank's place in it and its two groups."""

    data: int
    model: int
    rank: int
    data_group: Group
    model_group: Group
    device: torch.device
    world_group: Optional[Group] = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.data_group.rank

    @property
    def model_rank(self) -> int:
        return self.model_group.rank

    @property
    def tp(self) -> Optional[Group]:
        """The model group when tensor parallelism is on, else None."""
        return self.model_group if self.model > 1 else None

    @property
    def is_main(self) -> bool:
        """Global rank 0: model rank 0 of data rank 0, the rank that logs
        and writes the checkpoints."""
        return self.rank == 0


def single_mesh(device) -> Mesh:
    """The ``1 x 1`` mesh of one process without a process group."""
    one = Group(1, 0, (0,), None)
    return Mesh(1, 1, 0, one, one, resolve_device(device), one)


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def init_process_group(device="cuda") -> Optional[torch.device]:
    """Start (or join) the default process group from the launcher's
    environment and return this rank's device, or None when neither a
    group exists nor ``WORLD_SIZE`` is set (one process, no group).

    A group the caller has already initialised is used as it is (its
    backend too); otherwise NCCL on CUDA and gloo on the CPU, at
    ``tcp://MASTER_ADDR:MASTER_PORT``.  On CUDA each rank takes
    ``cuda:{LOCAL_RANK}`` (``RANK`` when unset) and raises when that
    device does not exist."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        world = _env_int("WORLD_SIZE")
        if world is None:
            return None
        rank = _env_int("RANK", 0)
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = _env_int("MASTER_PORT", 29500)
        if dev.type == "cuda":
            _set_cuda_device(rank)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world)
    if dev.type == "cuda":
        return _set_cuda_device(dist.get_rank())
    return dev


def _set_cuda_device(rank: int) -> torch.device:
    local = _env_int("LOCAL_RANK", rank)
    count = torch.cuda.device_count()
    if not 0 <= local < count:
        raise RuntimeError(f"LOCAL_RANK {local}: this machine shows {count} "
                           "CUDA device(s)")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def make_mesh(config: Optional[MeshConfig] = None, device="cuda",
              group: bool = True) -> Mesh:
    """The mesh of this process: ``init_process_group``, then the
    ``data x model`` grid over the world (resolved as the JAX package
    resolves it, so one process with ``model`` 2 raises ``mesh 0x2 != 1
    devices``).  Every rank makes every subgroup, in one order, as
    ``torch.distributed.new_group`` requires.

    ``group`` False (``model`` 1 only): no process group is started or
    joined; ``RANK`` and ``WORLD_SIZE`` alone place this process on the
    data axis and no collective runs over the mesh, for ranks that share
    nothing (the rollout's row shards at ``mesh.model`` 1)."""
    config = config or MeshConfig()
    if not group:
        if config.model != 1:
            raise ValueError(f"mesh.model {config.model} needs a process "
                             "group")
        world, rank = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
        config.resolve(world)
        dev = resolve_device(device)
        if dev.type == "cuda" and world > 1:
            dev = _set_cuda_device(rank)
        data = Group(world, rank, tuple(range(world)))
        return Mesh(world, 1, rank, data, Group(1, 0, (rank,)), dev, data)
    dev = init_process_group(device)
    if dev is None:
        config.resolve(1)
        return single_mesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = config.resolve(world)
    d, m = divmod(rank, cfg.model)
    data_ranks = [tuple(i * cfg.model + j for i in range(cfg.data))
                  for j in range(cfg.model)]
    model_ranks = [tuple(i * cfg.model + j for j in range(cfg.model))
                   for i in range(cfg.data)]
    data_pgs = [dist.new_group(list(r)) if world > 1 else dist.group.WORLD
                for r in data_ranks]
    model_pgs = [dist.new_group(list(r)) if cfg.model > 1 else None
                 for r in model_ranks]
    return Mesh(cfg.data, cfg.model, rank,
                Group(cfg.data, d, data_ranks[m], data_pgs[m]),
                Group(cfg.model, m, model_ranks[d], model_pgs[d]), dev,
                Group(world, rank, tuple(range(world)), dist.group.WORLD))
