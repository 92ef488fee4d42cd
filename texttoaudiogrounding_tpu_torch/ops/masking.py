"""Length-masked pooling over padded time axes, the segment mean and the
masked softmax (the JAX package's ``ops/masking.py:24-119``; reference
models/utils.py:22-105, models/text_encoder.py:51-58).

The MIL poolings keep the reference's semantics: ``linear_softmax`` is
``Σx² / Σx`` over the valid frames, and ``exp_softmax`` normalises by the
max over the whole padded axis before the exp.  A zero-length row gives
nan (``0 / 0``) or -inf, as in the JAX package.
"""

from __future__ import annotations

import torch


def generate_length_mask(lens: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask ``[N, max_length]``, True where index < length."""
    idxs = torch.arange(max_length, device=lens.device, dtype=lens.dtype)
    return idxs[None, :] < lens[:, None]


def _trailing(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``t`` with singleton axes appended up to ``ndim`` axes."""
    while t.ndim < ndim:
        t = t[..., None]
    return t


def sum_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked sum over axis 1.  features: [N, T, ...], lens: [N]."""
    mask = _trailing(generate_length_mask(lens, features.shape[1]),
                     features.ndim)
    return torch.sum(features * mask.to(features.dtype), dim=1)


def mean_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked mean over axis 1."""
    total = sum_with_lens(features, lens)
    return total / _trailing(lens.to(total.dtype), total.ndim)


def max_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked max over axis 1, the padded frames taken as -inf."""
    mask = _trailing(generate_length_mask(lens, features.shape[1]),
                     features.ndim)
    neg_inf = torch.full_like(features, -torch.inf)
    return torch.amax(torch.where(mask, features, neg_inf), dim=1)


def linear_softmax_with_lens(features: torch.Tensor,
                             lens: torch.Tensor) -> torch.Tensor:
    """MIL linear-softmax pooling: ``Σx² / Σx`` over the valid frames."""
    return sum_with_lens(features ** 2, lens) / sum_with_lens(features, lens)


def exp_softmax_with_lens(features: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """MIL exp-softmax pooling, normalised by the max over the padded
    axis (the reference's ``features.max(1)`` without a mask)."""
    normed = features - torch.amax(features, dim=1, keepdim=True)
    exp_f = torch.exp(normed)
    weight = exp_f / sum_with_lens(exp_f, lens)[:, None]
    return sum_with_lens(weight * features, lens)


def mean_by_group(arr: torch.Tensor, group_ids: torch.Tensor,
                  num_groups: int, group_sizes: torch.Tensor) -> torch.Tensor:
    """Segment mean: the rows of ``arr [total, ...]`` summed by their
    ``group_ids [total]`` into ``num_groups`` rows, each divided by its
    ``group_sizes`` entry (JAX ``masking.py:93``, one ``segment_sum``; an
    empty group gives ``0 / size``)."""
    summed = arr.new_zeros((num_groups,) + tuple(arr.shape[1:]))
    summed.index_add_(0, group_ids.long(), arr)
    denom = _trailing(group_sizes.to(summed.dtype), summed.ndim)
    return summed / denom


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with the positions where ``mask`` is False
    filled with -1e10 first, so that they take ~0 weight (JAX
    ``masking.py:108``, the reference's attention-pooling idiom)."""
    scores = torch.where(mask, scores, torch.full_like(scores, -1e10))
    return torch.softmax(scores, dim=dim)


POOLINGS = {"linear_softmax": linear_softmax_with_lens, "max": max_with_lens,
            "mean": mean_with_lens, "exp_softmax": exp_softmax_with_lens}
