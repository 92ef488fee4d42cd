"""Audio-text retrieval (CLAP-style) models, the auxiliary zoo that makes
phrase / audio embeddings offline.

Port of ``texttoaudiogrounding_tpu/models/retrieval.py`` (reference
audio_text_retrieval_models/): the PANNs ``Cnn14`` audio tower,
``RetrievalBert`` and the ``AudioTextClip`` / ``AudioSingleTextClip`` dual
encoders with a learnable logit scale and the reference's gradient
scaling (``grad_scale``, a ``torch.autograd.Function``).  The towers give
``{"clip_emb", "time_emb", "length"}``.  The conv blocks pool
``"avg"``, which no fused route takes (JAX ``layers.py:125-126``): they
run the plain path.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.device import place
from texttoaudiogrounding_tpu_torch.models.layers import (
    ConvBlock,
    Seeded,
    batch_norm,
    rank_stripes,
    spec_augment,
    spec_augment_stripes,
    xavier,
)
from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
    TextTower,
    TextTowerConfig,
)
from texttoaudiogrounding_tpu_torch.ops.frontend import (
    cnn8rnn_mel_config,
    log_mel_spectrogram,
)
from texttoaudiogrounding_tpu_torch.ops.masking import (
    max_with_lens,
    mean_with_lens,
)
from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import global_rows


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.alpha * g, None


def grad_scale(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """The identity, whose gradient is ``alpha · g`` (JAX
    ``retrieval.py:35-48``)."""
    return _GradScale.apply(x, alpha)


class AudioTower(Seeded):
    """What the PANNs towers share: the 64-mel frontend with ``bn0`` and
    SpecAugment, the frame length, and the clip pooling (masked max +
    mean, dropout 0.5, ``fc1`` + ReLU, dropout 0.5)."""

    def __init__(self, sample_rate: int, embed_dim: int,
                 downsample_ratio: int):
        super().__init__()
        self.sample_rate, self.embed_dim = sample_rate, embed_dim
        self.downsample_ratio = downsample_ratio
        self.mel_config = cnn8rnn_mel_config(sample_rate)
        self.bn0 = nn.BatchNorm1d(self.mel_config.n_mels)

    def _log_mel(self, input_dict: dict) -> torch.Tensor:
        """The normalised log-mel ``[B, T, M, 1]``, SpecAugmented in train
        mode when the input asks."""
        x = log_mel_spectrogram(input_dict["waveform"], self.mel_config)
        x = batch_norm(x, self.bn0, self.training)
        if self.training and input_dict.get("specaug", False):
            b, t, m = x.shape
            x = spec_augment(x, rank_stripes(spec_augment_stripes(
                self._dropout_generator(x.device), global_rows(b), t, m)))
        return x[..., None]

    def _clip(self, time_emb: torch.Tensor, input_dict: dict) -> dict:
        length = (input_dict["waveform_len"] // self.mel_config.hop_length
                  + 1) // self.downsample_ratio
        pooled = (max_with_lens(time_emb, length)
                  + mean_with_lens(time_emb, length))
        pooled = torch.relu(self.fc1(self._drop(pooled, 0.5)))
        return {"clip_emb": self._drop(pooled, 0.5), "time_emb": time_emb,
                "length": length}


_CNN14 = ((1, 64, (2, 2)), (64, 128, (2, 2)), (128, 256, (2, 2)),
          (256, 512, (2, 2)), (512, 1024, (2, 2)), (1024, 2048, (1, 1)))


class Cnn14(AudioTower):
    """PANNs Cnn14 (JAX ``retrieval.py:51-98``, reference
    audio_encoder.py:76-185): six ``"avg"``-pooled ``ConvBlock`` s (time
    ÷32), dropout 0.2 after each, the mean over mel → ``time_emb [B, T/32,
    2048]``, the clip pooling → ``clip_emb [B, 2048]``."""

    def __init__(self, sample_rate: int = 32000, embed_dim: int = 2048,
                 downsample_ratio: int = 32, device="cuda"):
        super().__init__(sample_rate, embed_dim, downsample_ratio)
        for i, (cin, cout, _) in enumerate(_CNN14, start=1):
            setattr(self, f"conv_block{i}", ConvBlock(cin, cout))
        self.fc1 = xavier(nn.Linear(2048, 2048))
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        x = self._log_mel(input_dict)
        for i, (_, _, pool) in enumerate(_CNN14, start=1):
            x = self._drop(getattr(self, f"conv_block{i}")(
                x, pool, pool_type="avg"), 0.2)
        return self._clip(x.mean(dim=2), input_dict)


class RetrievalBert(nn.Module):
    """[CLS]-pooled text tower for retrieval (JAX ``retrieval.py:101-118``,
    reference audio_text_retrieval_models/text_encoder.py:9-25):
    ``{"clip_emb": hidden[:, 0], "token_emb": hidden}``."""

    def __init__(self, cfg: TextTowerConfig, device="cuda"):
        super().__init__()
        self.cfg, self.embed_dim = cfg, cfg.hidden_size
        self.tower = TextTower(cfg, device=None)
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        hidden, _ = self.tower(input_dict["input_ids"],
                               input_dict["attention_mask"],
                               input_dict.get("token_type_ids"))
        return {"clip_emb": hidden[:, 0], "token_emb": hidden}


def _norm_clip(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    return torch.clamp(x / (norm + 1e-7), -1e3, 1e3)


class AudioTextClip(nn.Module):
    """CLIP-style dual encoder (JAX ``retrieval.py:126-190``, reference
    audio_text_retrieval_models/audio_text_model.py:32-105): the towers'
    ``clip_emb`` through ``grad_scale(·, gradient_clip)`` (when it is not
    1), ``audio_proj`` / ``text_proj`` and the clipped L2 norm; captions
    ``[B, N, L]`` go through the text tower as ``[B·N, L]``.  Returns
    ``{"audio_emb" [B, D], "text_emb" [B, N, D], "logit_scale"}``, the scale
    ``exp`` of its parameter, which starts at ``log(1 / 0.07)``."""

    def __init__(self, audio_encoder: nn.Module, text_encoder: nn.Module,
                 audio_dim: int, text_dim: int, shared_dim: int,
                 audio_forward_keys=("waveform", "waveform_len"),
                 text_forward_keys=("input_ids", "token_type_ids",
                                    "attention_mask"),
                 gradient_clip: float = 1.0, device="cuda"):
        super().__init__()
        self.audio_encoder, self.text_encoder = audio_encoder, text_encoder
        self.audio_forward_keys = tuple(audio_forward_keys)
        self.text_forward_keys = tuple(text_forward_keys)
        self.gradient_clip = gradient_clip
        self.audio_proj = nn.Linear(audio_dim, shared_dim)
        self.text_proj = nn.Linear(text_dim, shared_dim)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32))
        place(self, device)

    def _scaled(self, emb: torch.Tensor) -> torch.Tensor:
        if self.gradient_clip != 1:
            return grad_scale(emb, self.gradient_clip)
        return emb

    def encode_audio(self, input_dict: dict) -> torch.Tensor:
        emb = self._scaled(self.audio_encoder(input_dict)["clip_emb"])
        return _norm_clip(self.audio_proj(emb))

    def encode_text(self, text_input: dict) -> torch.Tensor:
        emb = self._scaled(self.text_encoder(text_input)["clip_emb"])
        return _norm_clip(self.text_proj(emb))

    def forward(self, input_dict: dict) -> dict:
        batch_size = input_dict["waveform"].shape[0]
        num_captions = input_dict.get("num_captions", 1)
        audio_emb = self.encode_audio(input_dict)
        text_input = {}
        for k in self.text_forward_keys:
            if k in input_dict:
                v = input_dict[k]
                text_input[k] = (v.reshape(batch_size * num_captions,
                                           *v.shape[2:])
                                 if v.dim() > 2 else v)
        text_emb = self.encode_text(text_input).reshape(
            batch_size, num_captions, -1)
        return {"audio_emb": audio_emb, "text_emb": text_emb,
                "logit_scale": torch.exp(self.logit_scale)}


class AudioSingleTextClip(AudioTextClip):
    """One caption an audio (JAX ``retrieval.py:193-200``): ``text_emb
    [B, D]``."""

    def forward(self, input_dict: dict) -> dict:
        audio_emb = self.encode_audio(input_dict)
        text_emb = self.encode_text({k: input_dict[k]
                                     for k in self.text_forward_keys
                                     if k in input_dict})
        return {"audio_emb": audio_emb, "text_emb": text_emb,
                "logit_scale": torch.exp(self.logit_scale)}
