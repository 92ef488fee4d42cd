"""Frame-vs-text match functions: per-frame similarity in (0, 1].

Ports of ``texttoaudiogrounding_tpu/models/match.py:32-72`` (``ExpNegL2``),
``:73-111`` (``DotProduct``; reference models/match.py:10-60) and
``:114-143`` (``CrossAttention``, reference :63-88).  Each is called as
``match_fn(audio [P, T, D], text, text_len)``; ``text`` is the text
encoder's dict or a tensor: the sequence-level ``seq_emb [P, D]``, or with
``text_level="token"`` the token-level ``token_emb [P, T, D]``, which a
cross encoder has aligned to the frames.  ``ExpNegL2`` and ``DotProduct``
have a ``pairwise`` form for the phrase models: one audio ``[B, T, D]``
against its N phrases ``[B, N, D]`` → ``[B, N, T]``, one product with no
``[B·N, T, D]`` broadcast of the audio.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.masking import generate_length_mask

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
    default, ``l2norm=True``): ``audio [P, T, D]`` × the text ``[P, D]``
    (``text_level="seq"``) or ``[P, T, D]`` (``"token"``) → ``[P, T]``."""

    def __init__(self, text_level: str = "seq"):
        super().__init__()
        self.text_level = text_level

    def forward(self, audio: torch.Tensor, text, text_len=None
                ) -> torch.Tensor:
        audio = l2_normalize(audio)
        text = l2_normalize(_text(text, self.text_level))
        if text.dim() == 2:
            text = text[:, None, :]
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
        """``audio [P, T, D]`` × ``text [P, D]`` or ``[P, T, D]`` (or a text
        dict, read at ``text_level``) → the pre-sigmoid scores ``[P, T]``."""
        text = _text(text, self.text_level)
        if self.l2norm:
            audio = l2_normalize(audio)
            text = l2_normalize(text)
        if text.dim() == 2:
            text = text[:, None, :]
        raw = torch.sum(audio * text, dim=-1)
        return raw / math.sqrt(audio.shape[-1]) if self.scale else raw

    def forward(self, audio: torch.Tensor, text, text_len=None
                ) -> torch.Tensor:
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



class DotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` over inputs of width
    ``embed_dim``: ``query``, ``key`` and ``value`` project to ``num_heads``
    heads of ``embed_dim // num_heads``, the query is scaled by
    ``1/sqrt(head_dim)``, masked scores are the dtype's lowest value (a row
    with no valid key attends uniformly, as in flax), and ``out`` projects
    the heads back.  The dense layers hold flax's ``DenseGeneral`` kernels
    flattened (``[D, H, Dh]`` → ``[H·Dh, D]``, ``[H, Dh, E]`` →
    ``[E, H·Dh]``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        self.num_heads, self.dropout = num_heads, dropout
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(embed_dim, embed_dim))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """``q_in [P, T, D]``, ``kv_in [P, L, D]``, ``mask [P, L]`` (True:
        attend) → ``[P, T, D]``."""
        p, t, d = q_in.shape
        h = self.num_heads

        def heads(x):
            return x.reshape(p, x.shape[1], h, d // h).transpose(1, 2)

        q = heads(self.query(q_in)) / math.sqrt(d // h)
        k, v = heads(self.key(kv_in)), heads(self.value(kv_in))
        score = q @ k.transpose(-1, -2)                      # [P, H, T, L]
        score = torch.where(mask[:, None, None, :], score,
                            torch.finfo(score.dtype).min)
        weight = torch.softmax(score, dim=-1)
        if self.training and self.dropout > 0:
            weight = F.dropout(weight, self.dropout)
        out = (weight @ v).transpose(1, 2).reshape(p, t, d)
        return self.out(out)


class CrossAttention(nn.Module):
    """Residual cross-attention scorer: the audio frames ``[P, T, D]``
    attend over the text tokens ``token_emb [P, L, D]`` masked by
    ``text_len``, then LayerNorm (epsilon 1e-6, as flax's), a linear layer
    and a sigmoid → ``[P, T]``.  Audio and text are ``embed_dim`` wide, as
    the residual needs of the audio and the models give the text (both
    projected to ``shared_dim``, or both the encoders' common width)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.attn = DotProductAttention(embed_dim, num_heads, dropout)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.linear = nn.Linear(embed_dim, 1)

    def forward(self, audio: torch.Tensor, text, text_len: torch.Tensor
                ) -> torch.Tensor:
        tokens = text["token_emb"] if isinstance(text, dict) else text
        mask = generate_length_mask(text_len, tokens.shape[1])
        out = self.attn(audio, tokens, mask)
        if self.training and self.dropout > 0:
            out = F.dropout(out, self.dropout)
        out = self.linear(self.norm(audio + out))[..., 0]
        return torch.sigmoid(out)
