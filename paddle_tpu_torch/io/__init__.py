"""Datasets, samplers and the single-process ``DataLoader`` (the port of
``paddle_tpu/io``).

The JAX package's samplers draw from numpy's global random state
(``np.random.permutation`` ...).  Here each takes an explicit
``generator``: an ``np.random.RandomState`` or ``np.random.Generator``
(``None``: a fresh, unseeded ``RandomState``); no sampler touches the
global state.  A ``RandomState(s)`` draws what the JAX package draws
after ``np.random.seed(s)``, so the two give the same permutations
from the same seed.

Batches come out of ``default_collate_fn`` as CPU tensors (numbers as
int64 / f32, as the JAX package's); ``hapi.Model`` moves them to its
network's device.  Not ported (each raises ``NotImplementedError``
naming its ROADMAP item): ``num_workers > 0`` (the JAX package's worker
processes and ``io/shm.py`` transport), ``DistributedBatchSampler``
(A3) and ``DeviceLoader``.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ConcatDataset", "ChainDataset", "Subset", "random_split", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "DataLoader",
    "DeviceLoader", "default_collate_fn",
]


def _rng(generator):
    return np.random.RandomState() if generator is None else generator


def _randint(rng, high, size):
    if isinstance(rng, np.random.Generator):
        return rng.integers(0, high, size)
    return rng.randint(0, high, size)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Samples ``tuple(t[i] for t in tensors)`` of tensors or arrays
    with a common first dimension."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Each sample the concatenation of the datasets' samples at one
    index."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            sample = ds[idx]
            out.extend(sample if isinstance(sample, (list, tuple))
                       else [sample])
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cumulative_sizes, idx,
                                     side="right"))
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx else 0
        return self.datasets[ds_idx][idx - prev]

    def __len__(self):
        return self.cumulative_sizes[-1]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint random ``Subset``s of the given lengths (or fractions,
    the last taking the rest), from one permutation of ``generator``."""
    if all(isinstance(n, float) for n in lengths):
        total = len(dataset)
        lengths = [int(math.floor(total * n)) for n in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != len(dataset):
        raise ValueError("lengths must sum to dataset size")
    perm = _rng(generator).permutation(len(dataset))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


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
    """A permutation of the indices (its first ``num_samples``), or with
    ``replacement`` ``num_samples`` uniform draws, from ``generator``,
    drawn anew at each iteration."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = _rng(generator)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(_randint(self.generator, n,
                                 self.num_samples).tolist())
        return iter(self.generator.permutation(n)[:self.num_samples]
                    .tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = _rng(generator)

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = self.generator.choice(len(self.weights), self.num_samples,
                                    replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Lists of ``batch_size`` indices from ``sampler``, or from a
    ``RandomSampler`` (``shuffle``, drawing from ``generator``) or a
    ``SequenceSampler`` over ``dataset``."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, generator=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, generator=generator)
        else:
            self.sampler = SequenceSampler(dataset)

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
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DistributedBatchSampler shards batches across data-parallel "
            "ranks, which waits for ROADMAP item A3 (parallelism across "
            "cards)")


class DeviceLoader:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DeviceLoader (device prefetch of batches) is not ported; it is "
            "listed in ROADMAP item A5")


def default_collate_fn(batch):
    """Stack a list of samples into batched CPU tensors, recursing into
    lists, tuples and dicts (ints as int64, floats as f32)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return batch


class DataLoader:
    """Batches of ``dataset`` in this process: through ``batch_sampler``,
    or a ``BatchSampler(dataset, shuffle, batch_size, drop_last,
    generator)``; ``batch_size=None`` yields the samples as they are.
    An ``IterableDataset`` is batched as it streams.  The JAX package's
    other arguments are taken; ``num_workers > 0`` raises."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, generator=None):
        if num_workers > 0:
            raise NotImplementedError(
                "DataLoader(num_workers > 0) (worker processes over the "
                "io/shm.py transport) is not ported; it is listed in ROADMAP "
                "item A5")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None          # no auto-batching
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last, generator=generator)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        return self._iter_single()

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_single(self):
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])
