"""Audio-text grounding models: audio encoder + text encoder +
projections + match.

Ports of ``texttoaudiogrounding_tpu/models/audio_text_model.py:105-154``
(``BiEncoder``, reference models/audio_text_model.py:16-98) and
``:57-84, 157-214`` (``MultiTextBiEncoder``, the phrase-level WSTAG
model, reference :101-229).  ``BiEncoder`` gives ``{"frame_sim" [B, T],
"length" [B]}``, and ``"logit" [B, T]``, the pre-sigmoid score, for a
match function that has one (``DotProduct``); ``MultiTextBiEncoder``
gives ``{"frame_sim" [B, T, N], "clip_sim" [B, N], "length" [B]}``.
``model.train()`` puts a model in train mode (batch-statistics BN,
dropout), as the JAX model's ``train=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.models.audio_encoder import Cnn8Rnn
from texttoaudiogrounding_tpu_torch.models.match import DotProduct
from texttoaudiogrounding_tpu_torch.models.text_encoder import EmbeddingAgg
from texttoaudiogrounding_tpu_torch.ops.masking import POOLINGS


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


class MultiTextBiEncoder(nn.Module):
    """One audio against N phrases: ``frame_sim [B, T, N]`` from the match
    function's ``pairwise`` form and ``clip_sim [B, N]``, the frames pooled
    over the valid length by ``pooling`` (``linear_softmax``, ``max``,
    ``mean`` or ``exp_softmax``).  The text keys ``[B, N, L]`` of
    ``text_forward_keys`` (``text_len`` always among them) go through the
    text encoder as ``[B·N, L]``.

    Not ported yet (ROADMAP.md, Queue 1: the rest of WSTAG, and the rest
    of the training surface for the freeze masks): the broadcast branch
    (a cross encoder, or a match function without a sequence-level
    ``pairwise``), ``upsample=True`` and the freeze flags."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 match_fn: nn.Module, shared_dim: int = 512,
                 text_forward_keys=("text", "text_len"),
                 cross_encoder: nn.Module | None = None,
                 pooling: str = "linear_softmax", add_proj: bool = False,
                 upsample: bool = False, freeze_audio_encoder: bool = False,
                 freeze_text_encoder: bool = False, device="cuda"):
        super().__init__()
        if (cross_encoder is not None or not hasattr(match_fn, "pairwise")
                or getattr(match_fn, "text_level", "seq") != "seq"):
            raise NotImplementedError(
                "only the pairwise branch (no cross encoder, a sequence-"
                "level match function with pairwise) is ported (ROADMAP.md, "
                "Queue 1: the rest of WSTAG)")
        if upsample or freeze_audio_encoder or freeze_text_encoder:
            raise NotImplementedError(
                "upsample and the freeze flags are not ported yet "
                "(ROADMAP.md, Queue 1: the rest of WSTAG, and the freeze "
                "masks in the rest of the training surface)")
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {sorted(POOLINGS)}")
        self.audio_encoder = audio_encoder
        self.text_encoder = text_encoder
        self.match_fn = match_fn
        self.pooling = pooling
        self.text_forward_keys = tuple(text_forward_keys)
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
        audio_emb = audio_out["embedding"]
        if self.needs_proj:
            audio_emb = self.audio_proj(audio_emb)
        keys = list(self.text_forward_keys)
        if "text_len" not in keys:
            keys.append("text_len")
        batch_size, text_num = input_dict[keys[0]].shape[:2]
        text_forward = {k: input_dict[k].reshape(-1, *input_dict[k].shape[2:])
                        for k in keys}
        seq_emb = self.text_encoder(text_forward)["seq_emb"]
        if self.needs_proj:
            seq_emb = self.text_proj(seq_emb)
        seq_emb = seq_emb.reshape(batch_size, text_num, -1)
        frame_sim = self.match_fn.pairwise(audio_emb, seq_emb).transpose(1, 2)
        length = audio_out["length"]
        return {"frame_sim": frame_sim,
                "clip_sim": POOLINGS[self.pooling](frame_sim, length),
                "length": length}


def flagship_model(serving: bool = True, device="cuda",
                   vocab_size: int = 5000, embed_dim: int = 512,
                   shared_dim: int = 512,
                   gru_kernel: bool | None = None,
                   block1_quant: str = "conv1",
                   block1_tc: int = 48,
                   block1_mode: str = "triple") -> BiEncoder:
    """The flagship grounding model (the JAX package's
    ``__graft_entry__._flagship_model``): ``BiEncoder(Cnn8Rnn,
    EmbeddingAgg(5000, 512), DotProduct, shared_dim=512, add_proj=True)``.
    ``serving=True`` is the int8 serving path (bf16 dtype, int8 conv
    blocks), ``False`` the f32 path; ``gru_kernel`` as in ``BiGRU``
    (``False`` with ``serving=False`` is the all-plain path);
    ``block1_quant``, ``block1_tc`` and ``block1_mode`` as in ``Cnn8Rnn``
    (the JAX ``TTG_B1_QUANT`` / ``TTG_B1_TC`` / ``TTG_B1_MODE``, read only
    by the serving path)."""
    audio = (Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8",
                     gru_kernel=gru_kernel, block1_quant=block1_quant,
                     block1_tc=block1_tc, block1_mode=block1_mode)
             if serving
             else Cnn8Rnn(gru_kernel=gru_kernel))
    return BiEncoder(audio, EmbeddingAgg(vocab_size, embed_dim),
                     DotProduct(), shared_dim=shared_dim, add_proj=True,
                     device=device)
