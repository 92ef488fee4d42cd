"""Cross (FiLM-style) fused models: the text added into every stage of a
CDur / Cnn8Rnn trunk → frame probabilities directly.

Port of ``texttoaudiogrounding_tpu/models/cross_models.py`` (reference
models/audio_text_model.py:461-840).  Activations are channel-last as in
the port's encoders; the BiGRUs run through the GRU kernels in f32
(``gru_kernel`` / ``gru_bwd`` as ``BiGRU``'s ``kernel`` / ``bwd``, in
place of JAX's ``TTG_PALLAS_GRU`` / ``TTG_GRU_BWD``).  In train mode the
BatchNorms take batch statistics, dropout masks, SpecAugment stripes
(``specaug`` true in the input) come from the model's generator, and
``CrossCnn8Rnn`` mixes the log-mel and the text embedding with
``mixup_lambda`` (its length is not mixed, as in the JAX model).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.device import place
from texttoaudiogrounding_tpu_torch.models.audio_text_model import (
    linear_upsample,
)
from texttoaudiogrounding_tpu_torch.models.layers import (
    BiGRU,
    Seeded,
    batch_norm,
    conv2d_cl,
    do_mixup,
    dropout,
    lp_pool_2d,
    pool_2d,
    rank_stripes,
    spec_augment,
    spec_augment_stripes,
    xavier,
)
from texttoaudiogrounding_tpu_torch.ops.frontend import (
    cdur_mel_config,
    cnn8rnn_mel_config,
    log_mel_spectrogram,
)
from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import global_rows


class CDurTextBlock(nn.Module):
    """BN → conv (with bias) → + ``fc_text(text)`` → LeakyReLU(0.1) (JAX
    ``cross_models.py:28-46``)."""

    def __init__(self, in_channels: int, out_channels: int, text_dim: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(in_channels)
        self.conv = xavier(nn.Conv2d(in_channels, out_channels, 3,
                                      padding=1))
        self.fc_text = xavier(nn.Linear(text_dim, out_channels))

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                bn_train: bool) -> torch.Tensor:
        x = conv2d_cl(batch_norm(x, self.bn, bn_train), self.conv)
        return F.leaky_relu(x + self.fc_text(text)[:, None, None, :], 0.1)


# CrossCDur's blocks: (in, out) channels and the LP pool after the block
_CDUR = (((1, 32), (2, 4)), ((32, 128), None), ((128, 128), (2, 4)),
         ((128, 128), None), ((128, 128), (1, 4)))


class CrossCDur(Seeded):
    """CDur trunk with the text at every block, and the output head (JAX
    ``cross_models.py:49-103``): ``{"frame_sim" [B, T], "length"}``.
    ``dropout`` is the train-mode rate after the trunk."""

    downsample_ratio = 4
    dropout = 0.3

    def __init__(self, sample_rate: int, text_encoder: nn.Module,
                 upsample: bool = False, gru_kernel: bool | None = None,
                 gru_bwd: str | None = None, device="cuda"):
        super().__init__()
        self.sample_rate, self.upsample = sample_rate, upsample
        self.time_resolution = 20 * self.downsample_ratio / 1000.0
        self.mel_config = cdur_mel_config(sample_rate)
        self.text_encoder = text_encoder
        dim = text_encoder.embed_dim
        for i, ((cin, cout), _) in enumerate(_CDUR, start=1):
            setattr(self, f"block{i}", CDurTextBlock(cin, cout, dim))
        self.gru = BiGRU(128, 128, kernel=gru_kernel, bwd=gru_bwd)
        self.fc_text = xavier(nn.Linear(dim, 256))
        self.fc_output = xavier(nn.Linear(256, 1))
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        train = self.training
        text_emb = self.text_encoder(input_dict)["seq_emb"]
        cfg = self.mel_config
        x = log_mel_spectrogram(input_dict["waveform"], cfg)[..., None]
        for i, (_, pool) in enumerate(_CDUR, start=1):
            x = getattr(self, f"block{i}")(x, text_emb, train)
            if pool is not None:
                x = lp_pool_2d(x, 4, pool)
        x = self._drop(x, self.dropout)
        b, t, m, c = x.shape
        x = self.gru(x.reshape(b, t, m * c), dtype=torch.float32)
        x = x + self.fc_text(text_emb)[:, None, :]
        logit = self.fc_output(x)[..., 0]
        prob = torch.clamp(torch.sigmoid(logit), 1e-7, 1.0)
        length = (input_dict["waveform_len"] // cfg.hop_length + 1
                  ) // self.downsample_ratio
        if self.upsample:
            prob = linear_upsample(prob[..., None],
                                   self.downsample_ratio)[..., 0]
            length = length * self.downsample_ratio
        return {"frame_sim": prob, "length": length}


class ConvTextBlock(nn.Module):
    """The PANNs double conv with ``fc_text(text)`` added after each BN,
    then the pool (JAX ``cross_models.py:106-134``)."""

    def __init__(self, in_channels: int, out_channels: int, text_dim: int):
        super().__init__()
        self.fc_text = xavier(nn.Linear(text_dim, out_channels))
        self.conv1 = xavier(nn.Conv2d(in_channels, out_channels, 3,
                                       padding=1, bias=False))
        self.conv2 = xavier(nn.Conv2d(out_channels, out_channels, 3,
                                       padding=1, bias=False))
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.bn2 = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor, text: torch.Tensor, bn_train: bool,
                pool_size=(2, 2), pool_type: str = "avg+max"
                ) -> torch.Tensor:
        t = self.fc_text(text)[:, None, None, :]
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = torch.relu(batch_norm(conv2d_cl(x, conv), bn, bn_train) + t)
        return pool_2d(x, tuple(pool_size), pool_type)


_CNN8 = ((1, 64, (2, 2)), (64, 128, (2, 2)), (128, 256, (1, 2)),
         (256, 512, (1, 2)))


class CrossCnn8Rnn(Seeded):
    """Cnn8Rnn trunk with the text at every stage (JAX
    ``cross_models.py:137-192``): ``{"frame_sim" [B, T, 1], "length"}``,
    the trailing class axis kept as in the reference (``FrameBceLoss``
    squeezes it).  ``freeze_bn`` keeps every BatchNorm on its running
    statistics in train mode; ``freeze_cnn`` is kept, as in JAX.
    ``dropout`` holds the train-mode rates after each block and after the
    mel mean."""

    downsample_ratio = 4
    time_resolution = 0.04
    dropout = (0.2, 0.5)

    def __init__(self, sample_rate: int, text_encoder: nn.Module,
                 freeze_cnn: bool = False, freeze_bn: bool = False,
                 upsample: bool = False, gru_kernel: bool | None = None,
                 gru_bwd: str | None = None, device="cuda"):
        super().__init__()
        self.sample_rate, self.upsample = sample_rate, upsample
        self.freeze_cnn, self.freeze_bn = freeze_cnn, freeze_bn
        self.mel_config = cnn8rnn_mel_config(sample_rate)
        self.text_encoder = text_encoder
        dim = text_encoder.embed_dim
        self.bn0 = nn.BatchNorm1d(64)
        for i, (cin, cout, _) in enumerate(_CNN8, start=1):
            setattr(self, f"conv_block{i}", ConvTextBlock(cin, cout, dim))
        self.fc1 = xavier(nn.Linear(512, 512))
        self.fc1_text = xavier(nn.Linear(dim, 512))
        self.rnn = BiGRU(512, 256, kernel=gru_kernel, bwd=gru_bwd)
        self.rnn_text = xavier(nn.Linear(dim, 512))
        self.fc_output = xavier(nn.Linear(512, 1))
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        train = self.training
        bn_train = train and not self.freeze_bn
        text_emb = self.text_encoder(input_dict)["seq_emb"]
        cfg = self.mel_config
        x = log_mel_spectrogram(input_dict["waveform"], cfg)
        x = batch_norm(x, self.bn0, bn_train)
        gen = self._dropout_generator(x.device) if train else None
        if train and input_dict.get("specaug", False):
            b, t, m = x.shape
            x = spec_augment(x, rank_stripes(spec_augment_stripes(
                gen, global_rows(b), t, m)))
        mixup_lambda = input_dict.get("mixup_lambda") if train else None
        if mixup_lambda is not None:
            x = do_mixup(x, mixup_lambda)
            text_emb = do_mixup(text_emb, mixup_lambda)
        x = x[..., None]
        p_block, p_mean = self.dropout if train else (0.0, 0.0)
        for i, (_, _, pool) in enumerate(_CNN8, start=1):
            x = dropout(getattr(self, f"conv_block{i}")(
                x, text_emb, bn_train, pool), p_block, gen)
        x = dropout(x.mean(dim=2), p_mean, gen)
        x = torch.relu(self.fc1(x) + self.fc1_text(text_emb)[:, None, :])
        x = self.rnn(x, dtype=torch.float32)
        x = x + self.rnn_text(text_emb)[:, None, :]
        prob = torch.clamp(torch.sigmoid(self.fc_output(x)), 1e-7, 1.0)
        length = (input_dict["waveform_len"] // cfg.hop_length + 1
                  ) // self.downsample_ratio
        if self.upsample:
            prob = linear_upsample(prob, self.downsample_ratio)
            length = length * self.downsample_ratio
        return {"frame_sim": prob, "length": length}
