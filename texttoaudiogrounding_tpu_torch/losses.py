"""Frame-level BCE for strong supervision.

Port of ``texttoaudiogrounding_tpu/losses.py:23-58`` (reference
losses.py:11-35): probability BCE with torch ``F.binary_cross_entropy``
semantics (each log clamped at -100) and its length-masked frame mean.
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
