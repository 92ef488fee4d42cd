"""Word-embedding text encoder (the "w2vmean" tower).

Port of ``texttoaudiogrounding_tpu/models/text_encoder.py:29-97``
(reference models/text_encoder.py:14-88): token embeddings, optionally
from a word2vec ``.npy`` table (``pretrained_embedding``), then mean or
attention pooling over the valid tokens.  ``freeze_embedding`` is read by
the optimizer's freeze mask (``training/optim.py``), as the JAX package
reads it, and keeps the table where it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.ops.masking import (
    generate_length_mask,
    mean_with_lens,
)


class EmbeddingLayer(nn.Module):
    """Token embedding; the table is ``embedding.core.weight`` as in the
    reference state dict, loaded from ``pretrained_embedding`` (an ``.npy``
    of shape ``[vocab_size, embed_dim]``) where one is named."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 pretrained_embedding: str | None = None,
                 freeze_embedding: bool = False):
        super().__init__()
        self.core = nn.Embedding(vocab_size, embed_dim)
        self.freeze_embedding = freeze_embedding
        if pretrained_embedding is not None:
            weight = np.load(pretrained_embedding)
            if weight.shape != (vocab_size, embed_dim):
                raise ValueError(
                    f"expect embedding with shape {(vocab_size, embed_dim)} "
                    f"but {weight.shape} is given")
            with torch.no_grad():
                self.core.weight.copy_(torch.from_numpy(
                    np.asarray(weight, np.float32)))

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        return self.core(text.long())


class AttentionPooling(nn.Module):
    """Learned scalar-score pooling with masked softmax (fill -1e10)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.fc = nn.Linear(embed_dim, 1)

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        score = self.fc(x)[..., 0]                          # [B, L]
        mask = generate_length_mask(lens, x.shape[1])
        score = torch.where(mask, score, torch.full_like(score, -1e10))
        weight = torch.softmax(score, dim=1)
        return torch.sum(x * weight[..., None], dim=1)


class EmbeddingAgg(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int,
                 pretrained_embedding: str | None = None,
                 freeze_embedding: bool = False, aggregation: str = "mean"):
        super().__init__()
        if aggregation not in ("mean", "attention"):
            raise ValueError(f"{aggregation} not supported")
        self.embed_dim = embed_dim
        self.aggregation = aggregation
        self.freeze_embedding = freeze_embedding
        self.embedding = EmbeddingLayer(vocab_size, embed_dim,
                                        pretrained_embedding,
                                        freeze_embedding)
        if aggregation == "attention":
            self.attn = AttentionPooling(embed_dim)

    def forward(self, input_dict: dict) -> dict:
        embs = self.embedding(input_dict["text"])
        lens = input_dict["text_len"]
        if self.aggregation == "mean":
            out = mean_with_lens(embs, lens)
        else:
            out = self.attn(embs, lens)
        return {"token_emb": embs, "seq_emb": out}
