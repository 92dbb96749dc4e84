"""Minimal data loading: shuffled batching + infinite iteration.  Copy of
``opadpo_tpu/data/loading.py``.

Replaces torch ``DataLoader`` + the reference's ``InfiniteLoader``
(``utils/common_utils.py:174-188``).  Host-side numpy only; the caller
moves batches to the device.  The shuffle draws from
``np.random.default_rng(seed)``, so the order matches the JAX package's
row for row.  Prefetching uses a thread pool so PIL decode/preprocess
overlaps device compute.
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Dict, Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 8):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers) \
            if self.num_workers > 1 else None
        try:
            for start in range(0, limit, self.batch_size):
                idxs = order[start:start + self.batch_size]
                if pool is not None:
                    items = list(pool.map(self.dataset.__getitem__, idxs))
                else:
                    items = [self.dataset[i] for i in idxs]
                yield self.collate_fn(items)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


class ShardedDataset:
    """Interleaved per-rank view of a dataset: rows ``rank::world_size``.

    Multi-rank rollout sharding (reference fans the query dataset across
    torchrun ranks via the DDP sampler, ``generator.py:87-93`` +
    ``record_step_stats`` per-rank shard files); here each process slices
    its rows host-side and the shards stay disjoint by construction.
    """

    def __init__(self, dataset, rank: int, world_size: int):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} outside world size {world_size}")
        self.dataset = dataset
        self.rank = rank
        self.world_size = world_size

    def __len__(self):
        n = len(self.dataset)
        return (n - self.rank + self.world_size - 1) // self.world_size

    def __getitem__(self, i):
        return self.dataset[self.rank + int(i) * self.world_size]


class InfiniteLoader:
    """Wraps a loader to yield forever (reference InfiniteLoader)."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self.iterator = iter(loader)

    def __next__(self) -> Dict:
        try:
            return next(self.iterator)
        except StopIteration:
            self.iterator = iter(self.loader)
            return next(self.iterator)

    def __iter__(self):
        return self
