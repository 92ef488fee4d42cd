"""Batches for the trainer: ``torch.utils.data.DataLoader`` with a seeded
``torch.Generator`` (its shuffle order is the same for the same seed), and
the copy of a numpy batch to the device.

A dataset that draws random numbers (``reseed(salt)``: negative phrases,
crops) is reseeded as the JAX package's loader does
(``texttoaudiogrounding_tpu/data/loader.py:178-182, 240-252``): once per
epoch by :meth:`Loader.set_epoch` when the batches are made in this
process, and before every batch with the salt ``seed + epoch · 1000003 +
i`` (``i`` the batch's index in the epoch) when worker processes make
them.  Each worker holds its own copy of the dataset, and so of its
``rng``; the per-batch salt makes a batch's items the same whichever
worker makes it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import BatchSampler, DataLoader, Dataset
from torch.utils.data import RandomSampler, SequentialSampler


class _SaltedBatches(BatchSampler):
    """Batches of ``(salt, index)`` keys: the salt is the batch's reseed
    when ``per_batch``, else None."""

    def __init__(self, sampler, batch_size: int, drop_last: bool, seed: int,
                 per_batch: bool):
        super().__init__(sampler, batch_size, drop_last)
        self.seed, self.per_batch, self.epoch = seed, per_batch, 0

    def __iter__(self):
        for i, idxs in enumerate(super().__iter__()):
            salt = (self.seed + self.epoch * 1000003 + i if self.per_batch
                    else None)
            yield [(salt, j) for j in idxs]


class _Reseeded(Dataset):
    """``dataset`` read by ``(salt, index)``: reseeded when the salt of the
    item differs from the last one (once per batch: a batch's items share
    it and one process makes them in order)."""

    def __init__(self, dataset):
        self.dataset = dataset
        self._salt = None

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        salt, index = key
        if salt is not None and salt != self._salt:
            self.dataset.reseed(salt)
            self._salt = salt
        return self.dataset[index]


class Loader(DataLoader):
    """A ``DataLoader`` over a dataset with ``reseed``; ``set_epoch``
    reseeds it for the epoch and moves the per-batch salts on."""

    def set_epoch(self, epoch: int) -> None:
        self.batch_sampler.epoch = epoch
        self.dataset.dataset.reseed(epoch)


def build_loader(dataset, collate_fn, seed: int, batch_size: int = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 0, **kwargs) -> DataLoader:
    gen = torch.Generator()
    gen.manual_seed(seed)
    if not hasattr(dataset, "reseed"):
        return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, collate_fn=collate_fn,
                          num_workers=num_workers, generator=gen, **kwargs)
    sampler = (RandomSampler(dataset, generator=gen) if shuffle
               else SequentialSampler(dataset))
    batches = _SaltedBatches(sampler, batch_size, drop_last, seed,
                             per_batch=num_workers > 0)
    return Loader(_Reseeded(dataset), batch_sampler=batches,
                  collate_fn=collate_fn, num_workers=num_workers, **kwargs)


def to_device(batch: dict, device: torch.device) -> dict:
    """Numeric numpy leaves → tensors on ``device``: integers as int64
    (token ids, lengths), floats as f32 (a float16 waveform is upcast on
    the device); strings and other metadata are dropped."""
    out = {}
    for key, value in batch.items():
        if not isinstance(value, np.ndarray) or value.dtype == object:
            continue
        if value.dtype.kind in "iub":
            out[key] = torch.from_numpy(value.astype(np.int64)).to(device)
        elif value.dtype.kind == "f":
            out[key] = torch.from_numpy(value).to(
                device, non_blocking=True).float()
    return out
