"""Align functions: every audio's frames against every text's items.

Port of ``texttoaudiogrounding_tpu/models/align.py`` (reference
models/align.py): ``audio [B, T, D]`` × ``text [B, N, D]`` →
``sim [B(audio), B(text), T, N]`` for the sentence-level ranking losses.
``AlignExpNegL2`` is the closed form ``|a - t|² = |a|² + |t|² - 2 a·t``
of the reference's double loop, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.models.match import l2_normalize

_EPS = 1e-12


class AlignDotProduct(nn.Module):
    """``sigmoid(a_i,t · t_j,n)`` (optionally over L2-normalized inputs and
    scaled by ``1/sqrt(D)``), clipped to [1e-7, 1]."""

    def __init__(self, l2norm: bool = False, scaled: bool = False):
        super().__init__()
        self.l2norm = l2norm
        self.scaled = scaled

    def forward(self, audio: torch.Tensor, text: torch.Tensor
                ) -> torch.Tensor:
        if self.l2norm:
            audio, text = l2_normalize(audio), l2_normalize(text)
        score = torch.einsum("itd,jnd->ijtn", audio, text)
        if self.scaled:
            score = score / math.sqrt(audio.shape[-1])
        return torch.clamp(torch.sigmoid(score), 1e-7, 1.0)


class AlignExpNegL2(nn.Module):
    """``exp(-|a_i,t - t_j,n|)`` over L2-normalized inputs."""

    def forward(self, audio: torch.Tensor, text: torch.Tensor
                ) -> torch.Tensor:
        audio, text = l2_normalize(audio), l2_normalize(text)
        a2 = torch.sum(audio * audio, dim=-1)                 # [B, T]
        t2 = torch.sum(text * text, dim=-1)                   # [B, N]
        at = torch.einsum("itd,jnd->ijtn", audio, text)
        d2 = torch.clamp_min(a2[:, None, :, None] + t2[None, :, None, :]
                             - 2.0 * at, 0.0)
        return torch.exp(-torch.sqrt(d2 + _EPS))
