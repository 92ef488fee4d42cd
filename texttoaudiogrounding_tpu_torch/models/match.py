"""Scaled sigmoid dot-product match: per-frame similarity in (0, 1].

Port of ``texttoaudiogrounding_tpu/models/match.py:73-111`` (reference
models/match.py:36-60).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_EPS = 1e-12


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=_EPS)


class DotProduct(nn.Module):
    def __init__(self, l2norm: bool = False, scale: bool = True,
                 text_level: str = "seq"):
        super().__init__()
        self.l2norm = l2norm
        self.scale = scale
        self.text_level = text_level

    def logits(self, audio: torch.Tensor, text) -> torch.Tensor:
        """``audio [P, T, D]`` × ``text [P, D]`` (or a text dict) → the
        pre-sigmoid scores ``[P, T]``."""
        if isinstance(text, dict):
            text = text["seq_emb" if self.text_level == "seq"
                        else "token_emb"]
        if self.l2norm:
            audio = l2_normalize(audio)
            text = l2_normalize(text)
        if text.dim() == 2:
            text = text[:, None, :]
        raw = torch.sum(audio * text, dim=-1)
        return raw / math.sqrt(audio.shape[-1]) if self.scale else raw

    def forward(self, audio: torch.Tensor, text) -> torch.Tensor:
        return torch.clamp(torch.sigmoid(self.logits(audio, text)),
                           1e-7, 1.0)

