"""Frame-vs-text match functions: per-frame similarity in (0, 1].

Ports of ``texttoaudiogrounding_tpu/models/match.py:32-72`` (``ExpNegL2``)
and ``:73-111`` (``DotProduct``; reference models/match.py:10-60).  Each
has a ``pairwise`` form for the phrase models: one audio ``[B, T, D]``
against its N phrases ``[B, N, D]`` → ``[B, N, T]``, one product with no
``[B·N, T, D]`` broadcast of the audio.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_EPS = 1e-12


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=_EPS)


def _text(text, text_level: str) -> torch.Tensor:
    if isinstance(text, dict):
        return text["seq_emb" if text_level == "seq" else "token_emb"]
    return text


class ExpNegL2(nn.Module):
    """``exp(-sqrt(Σ (a - t)² + 1e-12))`` on L2-normalized inputs (the JAX
    default, ``l2norm=True``): ``audio [P, T, D]`` × the sequence-level
    text ``[P, D]`` → ``[P, T]``."""

    def forward(self, audio: torch.Tensor, text) -> torch.Tensor:
        audio = l2_normalize(audio)
        text = l2_normalize(_text(text, "seq"))[:, None, :]
        diff = audio - text
        return torch.exp(-torch.sqrt(torch.sum(diff * diff, dim=-1) + _EPS))

    def pairwise(self, audio: torch.Tensor, text: torch.Tensor
                 ) -> torch.Tensor:
        """``audio [B, T, D]`` × ``text [B, N, D]`` → ``[B, N, T]``, with
        ``|a - t|² = |a|² + |t|² - 2 a·t``."""
        audio, text = l2_normalize(audio), l2_normalize(text)
        a2 = torch.sum(audio * audio, dim=-1)               # [B, T]
        t2 = torch.sum(text * text, dim=-1)                 # [B, N]
        at = torch.einsum("btd,bnd->bnt", audio, text)
        d2 = torch.clamp_min(a2[:, None, :] + t2[:, :, None] - 2.0 * at, 0.0)
        return torch.exp(-torch.sqrt(d2 + _EPS))


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
        text = _text(text, self.text_level)
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

    def pairwise(self, audio: torch.Tensor, text: torch.Tensor
                 ) -> torch.Tensor:
        """``audio [B, T, D]`` × ``text [B, N, D]`` → ``[B, N, T]``."""
        if self.l2norm:
            audio, text = l2_normalize(audio), l2_normalize(text)
        raw = torch.einsum("btd,bnd->bnt", audio, text)
        if self.scale:
            raw = raw / math.sqrt(audio.shape[-1])
        return torch.clamp(torch.sigmoid(raw), 1e-7, 1.0)

