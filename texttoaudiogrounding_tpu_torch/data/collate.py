"""Collate: a list of item dicts → a batch dict of numpy arrays.

Copies of ``texttoaudiogrounding_tpu/data/collate.py``'s
``VarLenPadCollate`` (:117-132, reference datasets/collate_function.py:
7-40: listed keys padded, the rest stacked, the items sorted by the
length of ``sort_key`` first, longest first, where one is given), its
``TextCollate``
(reference datasets/collate_function.py:43-84): listed keys are padded
(their lengths go to ``<key>_len``) up to a bucket multiple, the text
column is tokenized, numbers are stacked and strings stay lists; and of
its ``VarNumTextCollate`` (:172-205, reference :87-133) for a variable
number of phrases an item.
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def pad_sequence(data: list, bucket: int = 1, pad_to: int | None = None
                 ) -> tuple:
    """Pad ``[Ti, ...]`` arrays to ``[B, T, ...]``; T is the longest (or
    ``pad_to``) rounded up to ``bucket``; longer rows are cut to T."""
    arrs = [np.asarray(a) for a in data]
    lens = np.array([a.shape[0] for a in arrs], dtype=np.int64)
    t = int(lens.max()) if pad_to is None else pad_to
    t = round_up(max(t, 1), bucket)
    dt = np.result_type(*[a.dtype for a in arrs])
    out = np.zeros((len(arrs), t) + arrs[0].shape[1:], dtype=dt)
    for i, a in enumerate(arrs):
        n = min(a.shape[0], t)
        out[i, :n] = a[:n]
    return out, np.minimum(lens, t)


def _gather(data_batch: list) -> dict:
    """Item dicts → ``{key: [values]}``."""
    gathered: dict = {}
    for data in data_batch:
        for key, value in data.items():
            gathered.setdefault(key, []).append(value)
    return gathered


def _stack_or_list(values: list):
    if isinstance(values[0], (np.ndarray, int, float, bool,
                              np.integer, np.floating, np.bool_)):
        return np.array(values)
    return values


class VarLenPadCollate:
    """Pad the ``pad_keys`` (their lengths to ``{key}_len``) to the longest
    item, or to ``pad_to[key]``, rounded up to ``pad_buckets[key]``; stack
    the other numbers and keep strings as lists."""

    def __init__(self, pad_keys=(), sort_key=None, pad_buckets=None,
                 pad_to=None):
        self.pad_keys = list(pad_keys)
        self.sort_key = sort_key
        self.pad_buckets = dict(pad_buckets or {})
        self.pad_to = dict(pad_to or {})

    def __call__(self, data_batch: list) -> dict:
        if self.sort_key is not None:
            data_batch = sorted(data_batch,
                                key=lambda x: len(x[self.sort_key]),
                                reverse=True)
        output = {}
        for key, values in _gather(data_batch).items():
            if key in self.pad_keys:
                output[key], output[f"{key}_len"] = pad_sequence(
                    values, self.pad_buckets.get(key, 1),
                    self.pad_to.get(key))
            else:
                output[key] = _stack_or_list(values)
        return output


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

    def _text(self, values: list) -> dict:
        return self._bucket_text(self.tokenizer(values))

    def __call__(self, data_batch: list) -> dict:
        output = {"text_key": self.text_key}
        for key, values in _gather(data_batch).items():
            if key in self.pad_keys:
                output[key], output[f"{key}_len"] = pad_sequence(
                    values, self.pad_buckets.get(key, 1))
            elif key == self.text_key:
                output.update(self._text(values))
            else:
                output[key] = _stack_or_list(values)
        return output


class VarNumTextCollate(TextCollate):
    """``TextCollate`` over items whose text column is a list of phrases of
    any length: the phrases of the batch flattened to ``{key} [ΣN, L]``
    and ``{key}_len [ΣN]``, with ``{key}_num [B]`` and the gather map
    ``{key}_pad_index [B, max N]`` (flat row of phrase n of item b, 0 past
    ``{key}_num``), both int64, under the text column's own name."""

    def _text(self, values: list) -> dict:
        key = self.text_key
        nums = np.array([len(x) for x in values])
        tokens = super()._text([t for phrases in values for t in phrases])
        pad_index = np.zeros((len(nums), int(nums.max()) if len(nums)
                              else 1), np.int64)
        offset = 0
        for b, n in enumerate(nums):
            pad_index[b, :n] = np.arange(offset, offset + n)
            offset += n
        return {f"{key}_num": nums, key: tokens["text"],
                f"{key}_len": tokens["text_len"],
                f"{key}_pad_index": pad_index}
