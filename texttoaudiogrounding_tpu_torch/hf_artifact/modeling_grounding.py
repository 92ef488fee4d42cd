"""Self-contained torch modeling file shipped inside exported artifacts.

This file is COPIED into a deployment directory by
``texttoaudiogrounding_tpu_torch.deployment.export_hf_artifact`` so that
``transformers.AutoModel.from_pretrained(artifact_dir,
trust_remote_code=True)`` reconstructs the trained grounding model with
no dependency on this repo — the reference's release mechanism
(reference models/hf_modeling_grounding.py:305-352).  The package never
imports it.  It is the JAX package's ``hf_artifact/modeling_grounding.py``,
kept here as the port's own copy.

Differences from the reference wrapper, on purpose:

* no torchaudio — the mel frontend (periodic-Hann STFT, slaney mel
  filterbank, AmplitudeToDB) is implemented here with ``torch.stft`` and
  a filterbank computed at construction time, numerically matching
  torchaudio's ``MelSpectrogram`` and the package's frontend
  (ops/frontend.py);
* the text tower / match function are configurable from the config
  (the released reference artifact hard-codes CLAP text + DotProduct);
  the vocabulary of dictionary tokenizers rides inside ``config.json``
  so the artifact is a single directory with no hub fetches.

State-dict key names follow the reference checkpoint format
(``audio_encoder.conv_block1.conv1.weight`` …) — that naming IS the
published weight contract (the package's state dicts are in it), not
copied code.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from transformers import PretrainedConfig, PreTrainedModel


class GroundingConfig(PretrainedConfig):
    model_type = "text_audio_grounding"

    def __init__(self,
                 sample_rate: int = 32000,
                 shared_dim: int = 512,
                 add_proj: bool = False,  # matches the exporter/BiEncoder
                                          # default — a config.json missing
                                          # the field must not instantiate
                                          # proj layers the ckpt lacks
                 upsample: bool = False,
                 audio_encoder: Optional[dict] = None,
                 text_encoder: Optional[dict] = None,
                 match_fn: Optional[dict] = None,
                 vocab: Optional[Dict[str, int]] = None,
                 **kwargs):
        self.sample_rate = sample_rate
        self.shared_dim = shared_dim
        self.add_proj = add_proj
        self.upsample = upsample
        self.audio_encoder = audio_encoder or {"type": "Cnn8Rnn"}
        self.text_encoder = text_encoder or {
            "type": "EmbeddingAgg", "vocab_size": 2, "embed_dim": 512,
            "aggregation": "mean"}
        self.match_fn = match_fn or {"type": "DotProduct"}
        self.vocab = vocab or {}
        super().__init__(**kwargs)


# ---------------------------------------------------------------- frontend

def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    lin = freq / f_sp
    return np.where(freq >= min_log_hz,
                    min_log_hz / f_sp + np.log(freq / min_log_hz) / logstep,
                    lin)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    lin = f_sp * mels
    return np.where(mels >= min_log_hz / f_sp,
                    min_log_hz * np.exp(logstep * (mels - min_log_hz / f_sp)),
                    lin)


def _slaney_fbank(n_freqs: int, sample_rate: int, n_mels: int,
                  f_min: float, f_max: float) -> np.ndarray:
    """Triangular slaney-scale, slaney-normalized mel filterbank
    ``[n_freqs, n_mels]`` (torchaudio ``melscale_fbanks`` semantics)."""
    freqs = np.linspace(0.0, sample_rate / 2, n_freqs)
    pts = _mel_to_hz_slaney(np.linspace(
        _hz_to_mel_slaney(np.array(f_min)),
        _hz_to_mel_slaney(np.array(f_max)), n_mels + 2))
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[None, :-1],
                                    slopes[:, 2:] / diff[None, 1:]))
    fb *= (2.0 / (pts[2:] - pts[:-2]))[None, :]
    return fb.astype(np.float32)


class LogMelFrontend(nn.Module):
    """Waveform ``[B, N]`` → log-mel dB ``[B, T, 64]``, T = N//hop + 1."""

    def __init__(self, sample_rate: int):
        super().__init__()
        self.win_length = int(0.032 * sample_rate)
        self.hop_length = int(0.010 * sample_rate)
        f_max = 14000.0 if sample_rate == 32000 else sample_rate / 2
        fb = _slaney_fbank(self.win_length // 2 + 1, sample_rate, 64,
                           50.0, f_max)
        self.register_buffer("fbank", torch.from_numpy(fb),
                             persistent=False)
        self.register_buffer(
            "window", torch.hann_window(self.win_length, periodic=True),
            persistent=False)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        spec = torch.stft(waveform, n_fft=self.win_length,
                          hop_length=self.hop_length,
                          win_length=self.win_length, window=self.window,
                          center=True, pad_mode="reflect",
                          return_complex=True)          # [B, F, T]
        power = spec.real ** 2 + spec.imag ** 2
        mel = torch.matmul(power.transpose(1, 2), self.fbank)
        return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


# ------------------------------------------------------------- audio tower

class ConvBlock(nn.Module):
    """PANNs (conv3x3 → BN → ReLU) × 2 → avg+max pool."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.bn2 = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor, pool_size) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return (F.avg_pool2d(x, pool_size)
                + F.max_pool2d(x, pool_size))


class Cnn8Rnn(nn.Module):
    """4 PANNs conv blocks + BiGRU at 40 ms frames (the flagship audio
    encoder; numerics match the package's models.Cnn8Rnn)."""

    def __init__(self, sample_rate: int = 32000):
        super().__init__()
        self.frontend = LogMelFrontend(sample_rate)
        self.downsample_ratio = 4
        self.time_resolution = 0.04
        self.embed_dim = 512
        self.bn0 = nn.BatchNorm1d(64)
        self.conv_block1 = ConvBlock(1, 64)
        self.conv_block2 = ConvBlock(64, 128)
        self.conv_block3 = ConvBlock(128, 256)
        self.conv_block4 = ConvBlock(256, 512)
        self.fc1 = nn.Linear(512, 512)
        self.rnn = nn.GRU(512, 256, bidirectional=True, batch_first=True)

    def forward(self, input_dict: dict) -> dict:
        mel = self.frontend(input_dict["waveform"])     # [B, T, 64]
        x = self.bn0(mel.transpose(1, 2)).transpose(1, 2)
        x = x.unsqueeze(1)                              # [B, 1, T, 64]
        drop = lambda a: F.dropout(a, 0.2, self.training)  # noqa: E731
        x = drop(self.conv_block1(x, (2, 2)))
        x = drop(self.conv_block2(x, (2, 2)))
        x = drop(self.conv_block3(x, (1, 2)))
        x = drop(self.conv_block4(x, (1, 2)))
        x = x.mean(dim=3).transpose(1, 2)               # [B, T/4, 512]
        x = F.dropout(x, 0.5, self.training)
        x = F.relu(self.fc1(x))
        x, _ = self.rnn(x)
        length = (torch.as_tensor(input_dict["waveform_len"])
                  // self.frontend.hop_length + 1) // self.downsample_ratio
        return {"embedding": x, "length": length}


# -------------------------------------------------------------- text tower

class EmbeddingAgg(nn.Module):
    """Word embeddings + mean/attention pooling ("w2vmean")."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 aggregation: str = "mean"):
        super().__init__()
        self.embedding = nn.Module()
        self.embedding.core = nn.Embedding(vocab_size, embed_dim)
        self.aggregation = aggregation
        self.embed_dim = embed_dim
        if aggregation == "attention":
            self.attn = nn.Module()
            self.attn.fc = nn.Linear(embed_dim, 1)

    def forward(self, input_dict: dict) -> dict:
        embs = self.embedding.core(input_dict["text"].long())  # [B, L, D]
        lens = torch.as_tensor(input_dict["text_len"],
                               device=embs.device)
        mask = (torch.arange(embs.shape[1], device=embs.device)[None]
                < lens[:, None])
        if self.aggregation == "mean":
            seq = (embs * mask[..., None]).sum(1) / lens[:, None]
        else:
            score = self.attn.fc(embs)[..., 0]
            score = score.masked_fill(~mask, float("-inf")).softmax(dim=1)
            seq = (embs * score[..., None]).sum(1)
        return {"token_emb": embs, "seq_emb": seq}


# ----------------------------------------------------------- match + model

class DotProduct(nn.Module):
    def __init__(self, l2norm: bool = False, scale: bool = True,
                 text_level: str = "seq"):
        super().__init__()
        self.l2norm = l2norm
        self.scale = scale
        self.text_level = text_level

    def forward(self, input_dict: dict) -> torch.Tensor:
        audio = input_dict["audio_emb"]                 # [B, T, D]
        text = input_dict["text_emb"][f"{self.text_level}_emb"]
        if self.l2norm:
            audio = F.normalize(audio, dim=-1)
            text = F.normalize(text, dim=-1)
        if text.ndim == 2:
            text = text.unsqueeze(1)
        score = (audio * text).sum(-1)
        if self.scale:
            score = score / math.sqrt(audio.shape[-1])
        return torch.sigmoid(score).clamp(1e-7, 1.0)


class ExpNegL2(nn.Module):
    def __init__(self, l2norm: bool = True, text_level: str = "seq"):
        super().__init__()
        self.l2norm = l2norm
        self.text_level = text_level

    def forward(self, input_dict: dict) -> torch.Tensor:
        audio = input_dict["audio_emb"]
        text = input_dict["text_emb"][f"{self.text_level}_emb"]
        if self.l2norm:
            audio = F.normalize(audio, dim=-1, eps=1e-12)
            text = F.normalize(text, dim=-1, eps=1e-12)
        if text.ndim == 2:
            text = text.unsqueeze(1)
        diff = audio - text
        return torch.exp(-torch.sqrt((diff * diff).sum(-1) + 1e-12))


_TEXT_TOWERS = {"EmbeddingAgg": EmbeddingAgg}
_MATCH_FNS = {"DotProduct": DotProduct, "MatchDotProduct": DotProduct,
              "ExpNegL2": ExpNegL2, "MatchExpNegL2": ExpNegL2}


class BiEncoder(nn.Module):
    def __init__(self, config: GroundingConfig):
        super().__init__()
        self.audio_encoder = Cnn8Rnn(config.sample_rate)
        text_cfg = dict(config.text_encoder)
        self.text_encoder = _TEXT_TOWERS[text_cfg.pop("type")](**text_cfg)
        match_cfg = dict(config.match_fn)
        self.match_fn = _MATCH_FNS[match_cfg.pop("type")](**match_cfg)
        self.upsample = config.upsample
        self.needs_proj = (config.add_proj or self.audio_encoder.embed_dim
                           != self.text_encoder.embed_dim)
        if self.needs_proj:
            self.audio_proj = nn.Linear(self.audio_encoder.embed_dim,
                                        config.shared_dim)
            self.text_proj = nn.Linear(self.text_encoder.embed_dim,
                                       config.shared_dim)

    def forward(self, input_dict: dict) -> dict:
        audio_out = self.audio_encoder(input_dict)
        text_emb = self.text_encoder(input_dict)
        forward_dict = {"audio_emb": audio_out["embedding"],
                        "text_emb": text_emb,
                        "audio_len": audio_out["length"]}
        if self.needs_proj:
            forward_dict["audio_emb"] = self.audio_proj(
                forward_dict["audio_emb"])
            forward_dict["text_emb"] = {
                k: self.text_proj(v) for k, v in text_emb.items()}
        frame_sim = self.match_fn(forward_dict)
        length = audio_out["length"]
        ratio = self.audio_encoder.downsample_ratio
        if self.upsample and ratio != 1:
            frame_sim = F.interpolate(
                frame_sim.unsqueeze(1), frame_sim.shape[1] * ratio,
                mode="linear", align_corners=False).squeeze(1)
            length = length * ratio
        return {"frame_sim": frame_sim, "length": length}


class GroundingModel(PreTrainedModel):
    """``forward(audio [B, N], audio_len [B], text: List[str]) →
    frame probabilities [B, T]`` — tokenization inside, vocabulary from
    the config (reference hf_modeling_grounding.py:338-352 contract)."""

    config_class = GroundingConfig
    main_input_name = "audio"

    def __init__(self, config: GroundingConfig):
        super().__init__(config)
        self.model = BiEncoder(config)
        self.vocab = dict(config.vocab)

    def _tokenize(self, texts: List[str], device) -> dict:
        unk = self.vocab.get("<unk>", 0)
        ids = [[self.vocab.get(w, unk) for w in t.split()] or [unk]
               for t in texts]
        max_len = max(len(s) for s in ids)
        text = torch.zeros(len(ids), max_len, dtype=torch.long,
                           device=device)
        for i, s in enumerate(ids):
            text[i, :len(s)] = torch.as_tensor(s)
        lens = torch.as_tensor([len(s) for s in ids], device=device)
        return {"text": text, "text_len": lens}

    @torch.no_grad()
    def forward(self, audio: torch.Tensor, audio_len, text: List[str]
                ) -> torch.Tensor:
        device = next(self.parameters()).device
        input_dict = {"waveform": torch.as_tensor(audio, device=device,
                                                  dtype=torch.float32),
                      "waveform_len": torch.as_tensor(audio_len)}
        input_dict.update(self._tokenize(list(text), device))
        out = self.model(input_dict)
        probs = out["frame_sim"]
        mask = (torch.arange(probs.shape[1])[None]
                < out["length"][:, None]).to(probs.dtype)
        return probs * mask.to(probs.device)
