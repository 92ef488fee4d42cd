"""BiEncoder: audio encoder + text encoder + projections + match.

Port of ``texttoaudiogrounding_tpu/models/audio_text_model.py:105-154``
(reference models/audio_text_model.py:16-98).  Output:
``{"frame_sim" [B, T], "length" [B]}``, and ``"logit" [B, T]``, the
pre-sigmoid score, for a match function that has one (``DotProduct``).
``model.train()`` puts it in train mode (batch-statistics BN, dropout),
as the JAX model's ``train=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.models.audio_encoder import Cnn8Rnn
from texttoaudiogrounding_tpu_torch.models.match import DotProduct
from texttoaudiogrounding_tpu_torch.models.text_encoder import EmbeddingAgg


class BiEncoder(nn.Module):
    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, shared_dim: int = 512,
                 add_proj: bool = False, device="cuda"):
        super().__init__()
        self.audio_encoder = audio_encoder
        self.text_encoder = text_encoder
        self.match_fn = match_fn
        self.needs_proj = (add_proj or audio_encoder.embed_dim
                           != text_encoder.embed_dim)
        if self.needs_proj:
            self.audio_proj = nn.Linear(audio_encoder.embed_dim, shared_dim)
            self.text_proj = nn.Linear(text_encoder.embed_dim, shared_dim)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, input_dict: dict) -> dict:
        audio_out = self.audio_encoder(input_dict)
        text_emb = self.text_encoder(input_dict)
        audio_emb = audio_out["embedding"]
        if self.needs_proj:
            audio_emb = self.audio_proj(audio_emb)
            text_emb = {k: self.text_proj(v) for k, v in text_emb.items()}
        out = {"length": audio_out["length"]}
        if hasattr(self.match_fn, "logits"):
            out["logit"] = self.match_fn.logits(audio_emb, text_emb)
            out["frame_sim"] = torch.clamp(torch.sigmoid(out["logit"]),
                                           1e-7, 1.0)
        else:
            out["frame_sim"] = self.match_fn(audio_emb, text_emb)
        return out


def flagship_model(serving: bool = True, device="cuda",
                   vocab_size: int = 5000, embed_dim: int = 512,
                   shared_dim: int = 512,
                   gru_kernel: bool | None = None) -> BiEncoder:
    """The flagship grounding model (the JAX package's
    ``__graft_entry__._flagship_model``): ``BiEncoder(Cnn8Rnn,
    EmbeddingAgg(5000, 512), DotProduct, shared_dim=512, add_proj=True)``.
    ``serving=True`` is the int8 serving path (bf16 dtype, int8 conv
    blocks), ``False`` the f32 path; ``gru_kernel`` as in ``BiGRU``
    (``False`` with ``serving=False`` is the all-plain path)."""
    audio = (Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8",
                     gru_kernel=gru_kernel) if serving
             else Cnn8Rnn(gru_kernel=gru_kernel))
    return BiEncoder(audio, EmbeddingAgg(vocab_size, embed_dim),
                     DotProduct(), shared_dim=shared_dim, add_proj=True,
                     device=device)
