"""Batches for the trainer: ``torch.utils.data.DataLoader`` with a seeded
``torch.Generator`` (its shuffle order is the same for the same seed), and
the copy of a numpy batch to the device."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader


def build_loader(dataset, collate_fn, seed: int, batch_size: int = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 0, **kwargs) -> DataLoader:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      drop_last=drop_last, collate_fn=collate_fn,
                      num_workers=num_workers, generator=gen, **kwargs)


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
