"""Sharded sampling and a prefetching multiprocess loader — counterpart
of ``fgt_tpu/data/loader.py`` (which replaces the reference's torch
DataLoader + DistributedSampler, FGT/data/__init__.py:7-49).

Workers load items on the host only: the datasets are numpy and scipy,
and a worker never imports torch or touches the card.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import multiprocessing
import random
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


class ShardedSampler:
    """Deterministic per-epoch shuffling with equal-size shards
    (DistributedSampler semantics: pad by wrapping so every shard sees
    the same number of samples)."""

    def __init__(self, num_samples: int, shard: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} not in [0, {num_shards})")
        self.num_samples = num_samples
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return -(-self.num_samples // self.num_shards)

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.num_samples)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        per_shard = len(self)
        padded = np.resize(order, per_shard * self.num_shards)
        return iter(padded[self.shard::self.num_shards].tolist())


def default_collate(items: Sequence[dict]) -> dict:
    return {key: np.stack([it[key] for it in items], axis=0)
            for key in items[0]}


_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_load(idx: int, seed: int):
    random.seed(seed)
    np.random.seed(seed)
    return _WORKER_DATASET[idx]


class DataLoader:
    """Batches of an indexable dataset. ``num_workers=0`` loads inline;
    otherwise a process pool loads items in parallel with
    ``prefetch_batches`` batches in flight. A worker seeds ``random``
    and ``np.random`` before each item from a stream the loader draws
    from (seed, epoch), so two loaders of one seed and one sampler yield
    the same items whichever worker loads each (the JAX loader seeds a
    worker once, with seed + its pid, so its items differ from run to
    run; the tensor- and sequence-parallel ranks of one dp group must
    load the same). A worker's exception is raised where its batch is
    collated. Call
    :meth:`close` (or use the loader as a context manager) to stop the
    workers."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[ShardedSampler] = None,
                 num_workers: int = 0, drop_last: bool = True,
                 collate: Callable = default_collate,
                 prefetch_batches: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset))
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate = collate
        self.prefetch_batches = max(1, prefetch_batches)
        self.seed = seed
        self._pool = None

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _batches(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers <= 0:
            for batch in self._batches():
                yield self.collate([self.dataset[i] for i in batch])
            return
        if self._pool is None:
            # spawn, not fork: the trainers build their models on the card
            # (CUDA's threads run) before the first batch, and forking a
            # threaded process is unsafe (Python 3.12 warns of it)
            self._pool = cf.ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init, initargs=(self.dataset,))
        # a plain list of indices serves as a sampler too (one epoch)
        epoch = getattr(self.sampler, "epoch", 0)
        seeds = np.random.RandomState((self.seed + 7919 * epoch) % (2 ** 31))

        def submit(batch):
            return [self._pool.submit(_worker_load, i,
                                      int(seeds.randint(2 ** 31)))
                    for i in batch]

        pending: collections.deque = collections.deque()
        gen = self._batches()
        try:
            for _ in range(self.prefetch_batches):
                batch = next(gen, None)
                if batch is None:
                    break
                pending.append(submit(batch))
            while pending:
                futures = pending.popleft()
                batch = next(gen, None)
                if batch is not None:
                    pending.append(submit(batch))
                yield self.collate([f.result() for f in futures])
        finally:
            for futures in pending:
                for f in futures:
                    f.cancel()

    def close(self) -> None:
        """Stop the worker processes and wait for them to exit."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
