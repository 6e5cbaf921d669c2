"""Dataset abstractions (``paddle_tpu/io/dataset.py``): host data in numpy.

``TensorDataset`` takes numpy arrays, torch tensors and the port's
``Tensor``s, and keeps host copies of them; ``random_split`` draws from a
``numpy`` ``RandomState`` as the JAX package does, so one seed splits alike
in both packages.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch


class Dataset:
    """Map-style dataset: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """Stream-style dataset: __iter__."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        arrays = [
            t.detach().to("cpu").numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in tensors
        ]
        n = arrays[0].shape[0]
        for a in arrays:
            assert a.shape[0] == n, "all tensors must share dim 0"
        self._arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self._arrays)

    def __len__(self):
        return self._arrays[0].shape[0]


class ComposeDataset(Dataset):
    """Zip datasets: sample i is the concat of each dataset's sample i."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        for d in self.datasets:
            assert len(d) == n
        self._len = n

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            s = d[idx]
            out.extend(s if isinstance(s, (tuple, list)) else [s])
        return tuple(out)

    def __len__(self):
        return self._len


class ChainDataset(IterableDataset):
    """Concatenate iterable datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    rng = np.random.RandomState(
        generator if isinstance(generator, int) else None
    )
    perm = rng.permutation(n)
    out, start = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[start : start + ln].tolist()))
        start += ln
    return out


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        di = bisect.bisect_right(self.cum, idx)
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]
