"""Cross-encoder fusion: the audio frames attend over the text tokens, then
the two gate each other.

Port of ``texttoaudiogrounding_tpu/models/cross_encoder.py`` (reference
models/cross_encoder.py:5-79).  ``CrossAttentionGating(embed_dim)`` takes
``{"audio_emb" [P, T, D], "text_emb" (a dict with ``token_emb [P, L, D]``,
or the tensor), "audio_len" [P], "text_len" [P]}`` and returns
``{"audio_emb" [P, T, D], "text_emb": {"token_emb" [P, T, D]}}``: the text
attended for each frame, so that a token-level match function can score
it frame by frame.  Audio and text are ``embed_dim`` wide, as the mutual
gating needs.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.ops.masking import generate_length_mask


class Seq2SeqAttention(nn.Module):
    """Additive attention of the query frames over the kv tokens:
    ``v · tanh(h2attn_q(q) + h2attn_k(k))`` (``h2attn_k`` without bias; the
    reference's ``h2attn`` over ``[q; k]``, split), the scores of a padded
    query or key -1e10, a softmax over the keys, the keys averaged."""

    def __init__(self, d_attn: int, d_query: int, d_kv: int):
        super().__init__()
        self.h2attn_q = nn.Linear(d_query, d_attn)
        self.h2attn_k = nn.Linear(d_kv, d_attn, bias=False)
        self.v = nn.Parameter(torch.randn(d_attn))        # flax normal(1.0)

    def forward(self, query: torch.Tensor, kv: torch.Tensor,
                query_len: torch.Tensor, kv_len: torch.Tensor
                ) -> torch.Tensor:
        hidden = torch.tanh(self.h2attn_q(query)[:, :, None, :]
                            + self.h2attn_k(kv)[:, None, :, :])
        score = torch.einsum("bqka,a->bqk", hidden, self.v)
        qmask = generate_length_mask(query_len, query.shape[1])
        kmask = generate_length_mask(kv_len, kv.shape[1])
        low = torch.full_like(score, -1e10)
        score = torch.where(qmask[:, :, None], score, low)
        score = torch.where(kmask[:, None, :], score, low)
        return torch.einsum("bqk,bkd->bqd", torch.softmax(score, dim=-1), kv)


class CrossGating(nn.Module):
    """Mutual sigmoid gating: ``s · σ(fc_u(u))`` and ``u · σ(fc_s(s))``."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc_u = nn.Linear(dim, dim)
        self.fc_s = nn.Linear(dim, dim)

    def forward(self, u: torch.Tensor, s: torch.Tensor) -> tuple:
        s_out = s * torch.sigmoid(self.fc_u(u))
        u_out = u * torch.sigmoid(self.fc_s(s))
        return u_out, s_out


class CrossAttentionGating(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.attn = Seq2SeqAttention(embed_dim, embed_dim, embed_dim)
        self.gating = CrossGating(embed_dim)

    def forward(self, input_dict: dict) -> dict:
        audio_emb = input_dict["audio_emb"]
        text_emb = input_dict["text_emb"]
        if isinstance(text_emb, dict):
            text_emb = text_emb["token_emb"]
        attended = self.attn(audio_emb, text_emb, input_dict["audio_len"],
                             input_dict["text_len"])
        audio_out, text_out = self.gating(audio_emb, attended)
        return {"audio_emb": audio_out, "text_emb": {"token_emb": text_out}}
