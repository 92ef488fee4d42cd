"""Text encoders: token ids → ``{"seq_emb": [B, D], "token_emb": [B, L,
D]}``.

Port of ``texttoaudiogrounding_tpu/models/text_encoder.py`` (reference
models/text_encoder.py): ``EmbeddingAgg`` (``:29-97``, the "w2vmean"
tower: token embeddings, optionally from a word2vec ``.npy`` table
(``pretrained_embedding``), then mean or attention pooling over the valid
tokens), ``RnnEncoder``, ``IntraAttention`` (with ``ConvGRUCell``) and
``SelfAttention`` (``:100-231``).  ``freeze_embedding`` is read by
the optimizer's freeze mask (``training/optim.py``), as the JAX package
reads it, and keeps the table where it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.models.layers import (
    GRU,
    LSTM,
    RNN,
    PositionalEncoding,
)
from texttoaudiogrounding_tpu_torch.models.match import DotProductAttention
from texttoaudiogrounding_tpu_torch.ops.masking import (
    generate_length_mask,
    masked_softmax,
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
        weight = masked_softmax(score, generate_length_mask(lens, x.shape[1]),
                                dim=1)
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


class RnnEncoder(nn.Module):
    """Embedding → RNN → mean over ``text_len`` (JAX
    ``text_encoder.py:100-137``, reference models/text_encoder.py:91-125):
    ``rnn_type`` ``"GRU"`` (:class:`~layers.GRU`: a bidirectional layer
    runs through the GRU kernels in f32, as JAX's ``BiGRU`` takes
    ``bigru_pallas_trainable``; ``gru_kernel`` / ``gru_bwd`` as
    ``BiGRU``'s ``kernel`` / ``bwd``), ``"RNN"`` (Elman, tanh) or
    ``"LSTM"``, over the padded sequence.  ``dropout`` and ``pooling`` are
    kept and unused, as in the JAX module."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden_dim: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 bidirectional: bool = False, rnn_type: str = "GRU",
                 pooling: str = "mean", gru_kernel: bool | None = None,
                 gru_bwd: str | None = None):
        super().__init__()
        self.embedding = EmbeddingLayer(vocab_size, embed_dim)
        if rnn_type == "GRU":
            self.rnn = GRU(embed_dim, hidden_dim, num_layers, bidirectional,
                           kernel=gru_kernel, bwd=gru_bwd)
        elif rnn_type == "RNN":
            self.rnn = RNN(embed_dim, hidden_dim, num_layers, bidirectional)
        elif rnn_type == "LSTM":
            self.rnn = LSTM(embed_dim, hidden_dim, num_layers, bidirectional)
        else:
            raise ValueError(f"bad rnn_type {rnn_type}")
        self.out_dim = self.embed_dim = hidden_dim * (2 if bidirectional
                                                      else 1)

    def forward(self, input_dict: dict) -> dict:
        token_emb = self.rnn(self.embedding(input_dict["text"]))
        return {"token_emb": token_emb,
                "seq_emb": mean_with_lens(token_emb, input_dict["text_len"])}


class ConvGRUCell(nn.Module):
    """Position-wise graph-update GRU cell (JAX ``text_encoder.py:140-160``,
    reference models/text_encoder.py:147-188 with kernel size 1):
    ``update_gate`` / ``reset_gate`` / ``out_gate`` over the concatenated
    ``[input, state]``, orthogonal kernels."""

    def __init__(self, hidden_size: int):
        super().__init__()
        for name in ("update_gate", "reset_gate", "out_gate"):
            layer = nn.Linear(2 * hidden_size, hidden_size)
            nn.init.orthogonal_(layer.weight)
            nn.init.zeros_(layer.bias)
            setattr(self, name, layer)

    def forward(self, inputs: torch.Tensor, state: torch.Tensor
                ) -> torch.Tensor:
        stacked = torch.cat([inputs, state], dim=-1)
        update = torch.sigmoid(self.update_gate(stacked))
        reset = torch.sigmoid(self.reset_gate(stacked))
        out = torch.tanh(self.out_gate(torch.cat([inputs, state * reset],
                                                 dim=-1)))
        return state * (1 - update) + out * update


class IntraAttention(nn.Module):
    """Self-attention message passing with a :class:`ConvGRUCell` update
    (JAX ``text_encoder.py:163-200``, reference :191-237).  Two reference
    quirks stay: scores of invalid token pairs are set to the *value*
    1e-10 (not -inf) before the softmax, and each layer draws ``pe(x)``
    twice (two dropout masks in train mode)."""

    def __init__(self, vocab_size: int, embed_dim: int, num_layers: int = 1,
                 pooling: str = "mean"):
        super().__init__()
        self.embed_dim, self.num_layers = embed_dim, num_layers
        self.embedding = EmbeddingLayer(vocab_size, embed_dim)
        self.pe = PositionalEncoding(0.2)
        self.conv_gru = ConvGRUCell(embed_dim)

    def forward(self, input_dict: dict) -> dict:
        x = self.embedding(input_dict["text"])
        lens = input_dict["text_len"]
        mask = generate_length_mask(lens, x.shape[1])          # [B, L]
        pair = mask[:, None, :] & mask[:, :, None]
        for _ in range(self.num_layers):
            score = self.pe(x) @ self.pe(x).transpose(1, 2)
            score = torch.where(pair, score, torch.full_like(score, 1e-10))
            x = self.conv_gru(torch.softmax(score, dim=2) @ x, x)
        return {"token_emb": x, "seq_emb": mean_with_lens(x, lens)}


class SelfAttention(nn.Module):
    """One multi-head attention block over ``[CLS] + tokens`` with
    positions (JAX ``text_encoder.py:203-231``, reference :240-268):
    ``seq_emb`` is the CLS output.  ``cls_token`` starts at zero;
    ``mha`` is flax's ``MultiHeadDotProductAttention``
    (:class:`~match.DotProductAttention`), masked on the keys by
    ``text_len + 1``."""

    def __init__(self, vocab_size: int, embed_dim: int, num_heads: int,
                 dropout: float = 0.2, pretrained_embedding: str | None = None,
                 freeze_embedding: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.freeze_embedding = freeze_embedding
        self.embedding = EmbeddingLayer(vocab_size, embed_dim,
                                        pretrained_embedding,
                                        freeze_embedding)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pe = PositionalEncoding(dropout)
        self.mha = DotProductAttention(embed_dim, num_heads, dropout)

    def forward(self, input_dict: dict) -> dict:
        x = self.embedding(input_dict["text"])
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], dim=1)
        x = self.pe(x)
        mask = generate_length_mask(input_dict["text_len"] + 1, x.shape[1])
        x = self.mha(x, x, mask)
        return {"token_emb": x[:, 1:], "seq_emb": x[:, 0]}
