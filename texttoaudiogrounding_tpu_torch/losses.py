"""BCE losses: frame-level for strong supervision, clip-level for WSTAG.

Port of ``texttoaudiogrounding_tpu/losses.py:23-71`` (reference
losses.py:11-43): probability BCE with torch ``F.binary_cross_entropy``
semantics (each log clamped at -100), its length-masked frame mean and
its plain mean over the clip-phrase scores.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.ops.masking import generate_length_mask

_LOG_CLAMP = -100.0


def binary_cross_entropy(prob: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE on probabilities."""
    log_p = torch.clamp_min(torch.log(prob), _LOG_CLAMP)
    log_1p = torch.clamp_min(torch.log1p(-prob), _LOG_CLAMP)
    return -(target * log_p + (1.0 - target) * log_1p)


class FrameBceLoss:
    """Length-masked frame BCE: ``output`` holds ``frame_sim [B, T]``,
    ``label [B, T]`` and ``length [B]``."""

    def __call__(self, output: dict) -> torch.Tensor:
        frame_sim = output["frame_sim"]
        loss = binary_cross_entropy(frame_sim, output["label"])
        mask = generate_length_mask(output["length"],
                                    frame_sim.shape[1]).to(loss.dtype)
        return torch.sum(loss * mask) / torch.sum(mask)


class ClipBceLoss:
    """Clip-level BCE: the mean over ``clip_sim [B, N]`` against ``label
    [B, N]`` (1 for a caption's phrases, 0 for sampled negatives)."""

    def __call__(self, output: dict) -> torch.Tensor:
        return torch.mean(binary_cross_entropy(output["clip_sim"],
                                               output["label"]))
