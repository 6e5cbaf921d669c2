"""Samplers (``paddle_tpu/io/sampler.py``).

Host indices drawn from numpy's global stream with the JAX package's calls
in its order (``RandomSampler``: ``np.random.randint``/``permutation``;
``WeightedRandomSampler``: ``np.random.choice``), so one ``np.random.seed``
gives the same indices in both packages.
"""
from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(
            len(self.weights), self.num_samples, replace=self.replacement, p=p
        )
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """fluid/dataloader/batch_sampler.py:BatchSampler."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """distributed/fleet version: shard sample indices over dp ranks.

    The rank and world size default to the launcher's environment
    (``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``); one process is rank 0
    of 1.
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..monitor.flight_recorder import _safe_rank, _safe_world

        self.nranks = num_replicas or _safe_world()
        self.local_rank = rank if rank is not None else _safe_rank()
        super().__init__(dataset, None, shuffle, batch_size, drop_last)
        self.epoch = 0

    def __iter__(self):
        n = len(self.data_source)
        indices = np.arange(n)
        if isinstance(self.sampler, RandomSampler):
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n)
        # pad to a multiple of nranks then take this rank's slice
        total = ((n + self.nranks - 1) // self.nranks) * self.nranks
        indices = np.concatenate([indices, indices[: total - n]])
        local = indices[self.local_rank :: self.nranks]
        batch = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = (len(self.data_source) + self.nranks - 1) // self.nranks
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
