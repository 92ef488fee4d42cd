"""Collate: a list of item dicts → a batch dict of numpy arrays.

A copy of ``texttoaudiogrounding_tpu/data/collate.py``'s ``TextCollate``
(reference datasets/collate_function.py:43-84): listed keys are padded
(their lengths go to ``<key>_len``) up to a bucket multiple, the text
column is tokenized, numbers are stacked and strings stay lists.
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def pad_sequence(data: list, bucket: int = 1) -> tuple:
    """Pad ``[Ti, ...]`` arrays to ``[B, T, ...]``; T is the longest
    rounded up to ``bucket``."""
    arrs = [np.asarray(a) for a in data]
    lens = np.array([a.shape[0] for a in arrs], dtype=np.int64)
    t = round_up(max(int(lens.max()), 1), bucket)
    dt = np.result_type(*[a.dtype for a in arrs])
    out = np.zeros((len(arrs), t) + arrs[0].shape[1:], dtype=dt)
    for i, a in enumerate(arrs):
        n = min(a.shape[0], t)
        out[i, :n] = a[:n]
    return out, np.minimum(lens, t)


def _stack_or_list(values: list):
    if isinstance(values[0], (np.ndarray, int, float, bool,
                              np.integer, np.floating, np.bool_)):
        return np.array(values)
    return values


class TextCollate:
    def __init__(self, tokenizer, text_key: str = "text", pad_keys=(),
                 pad_buckets=None, text_bucket: int = 1):
        self.tokenizer = tokenizer
        self.text_key = text_key
        self.pad_keys = list(pad_keys)
        self.pad_buckets = dict(pad_buckets or {})
        self.text_bucket = text_bucket

    def _bucket_text(self, tokens: dict) -> dict:
        if self.text_bucket <= 1:
            return tokens
        out = dict(tokens)
        for k, v in tokens.items():
            if k.endswith("_len") or v.ndim < 2:
                continue
            t = round_up(v.shape[-1], self.text_bucket)
            out[k] = np.pad(v, [(0, 0)] * (v.ndim - 1)
                            + [(0, t - v.shape[-1])])
        return out

    def __call__(self, data_batch: list) -> dict:
        gathered: dict = {}
        for data in data_batch:
            for key, value in data.items():
                gathered.setdefault(key, []).append(value)
        output = {"text_key": self.text_key}
        for key, values in gathered.items():
            if key in self.pad_keys:
                output[key], output[f"{key}_len"] = pad_sequence(
                    values, self.pad_buckets.get(key, 1))
            elif key == self.text_key:
                output.update(self._bucket_text(self.tokenizer(values)))
            else:
                output[key] = _stack_or_list(values)
        return output
