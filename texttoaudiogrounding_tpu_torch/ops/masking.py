"""Length-masked pooling over padded time axes (the JAX package's
``ops/masking.py:24-58``; reference models/utils.py:22-58)."""

from __future__ import annotations

import torch


def generate_length_mask(lens: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask ``[N, max_length]``, True where index < length."""
    idxs = torch.arange(max_length, device=lens.device, dtype=lens.dtype)
    return idxs[None, :] < lens[:, None]


def mean_with_lens(features: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked mean over axis 1.  features: [N, T, ...], lens: [N]."""
    mask = generate_length_mask(lens, features.shape[1])
    while mask.ndim < features.ndim:
        mask = mask[..., None]
    total = torch.sum(features * mask.to(features.dtype), dim=1)
    denom = lens.to(total.dtype)
    while denom.ndim < total.ndim:
        denom = denom[..., None]
    return total / denom
