"""Cnn8Rnn audio encoder: waveform → frame embeddings + frame lengths.

Port of ``texttoaudiogrounding_tpu/models/audio_encoder.py:60-144``
(reference models/audio_encoder.py:89-232): log-mel (64 slaney mels) →
bn0 over the mel axis → 4 PANNs conv blocks (64→128→256→512, avg+max
pools, time ÷4, mel ÷16) → mean over mel → FC512 + ReLU → BiGRU(256×2).
``length = (waveform_len // hop + 1) // 4``.

The JAX package picks its kernels with environment variables
(``TTG_FUSED_CONV``, ``TTG_B1_QUANT``, ``TTG_BN_POOL``, ``TTG_POOL_VJP``,
``TTG_GRU_BWD``, ``TTG_PALLAS_GRU``); here the constructor says it:

* ``Cnn8Rnn()``: the f32 path, whose BiGRU runs through the GRU kernels
  (``gru_kernel=False`` keeps it on the plain loop);
* ``Cnn8Rnn(dtype=torch.bfloat16)``: the bf16 mixed-precision mode, in
  train and eval: the log-mel kernel, bn0 in f32 per mel, the blocks
  (PyTorch convolutions with bf16 operands, f32 BN statistics and
  normalisation) and dropout in bf16, the mel mean in bf16 feeding the f32
  ``fc1``;
* ``Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8")`` (or ``"bf16"``):
  the serving kernels for the blocks, eval mode only; ``"int8"`` is the
  flagship serving path.  There ``block1_quant`` and ``block1_tc`` take
  the place of ``TTG_B1_QUANT`` and ``TTG_B1_TC`` (``ConvBlock``):
  ``"conv1"`` (the default, the JAX ``mixed``), ``"int8"`` (``1``: block 1
  all in int8) or ``"bf16"`` (``0``), and ``block1_mode`` that of
  ``TTG_B1_MODE``: ``"triple"`` (the default) or ``"single"``.

``bn_pool`` and ``pool_vjp`` list the out-channels of the blocks that run
the pool kernels (``ConvBlock``); ``gru_bwd`` is ``BiGRU``'s ``bwd``:
``"bf16"`` picks the bf16 trainable GRU, ``"v2"`` / ``"v3"`` the hoisted
f32 backward.  ``freeze_cnn`` and ``freeze_bn`` are taken, as the shipped
configs name them, only as False.  The BiGRU is f32 in train mode and
in the module's dtype in eval mode (``audio_encoder.py:133``): in bf16,
the grouped loop with bf16 operands and carry unless ``gru_kernel``.

In train mode (``audio_encoder.py:85-144``) bn0 and the blocks'
BatchNorms use batch statistics, ``Dropout(0.2)`` follows each block and
``Dropout(0.5)`` the mel mean, with masks drawn from the module's own
``torch.Generator`` (seeded, when first used, from the torch seed: the
trainer's config seed).  Spec-augment and mixup are not ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.models.layers import (
    BiGRU,
    ConvBlock,
    batch_norm_eval,
    batch_norm_train,
)
from texttoaudiogrounding_tpu_torch.ops.frontend import (
    cnn8rnn_mel_config,
    log_mel_spectrogram,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.logmel import (
    fused_log_mel_spectrogram,
)

_BLOCKS = ((1, 64, (2, 2)), (64, 128, (2, 2)), (128, 256, (1, 2)),
           (256, 512, (1, 2)))


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - p``, scale kept
    values by ``1 / (1 - p)``; the mask comes from ``generator``."""
    if p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


class Cnn8Rnn(nn.Module):
    downsample_ratio = 4
    time_resolution = 0.04
    embed_dim = 512

    def __init__(self, sample_rate: int = 32000,
                 dtype: torch.dtype = torch.float32,
                 conv_mode: str | None = None,
                 gru_kernel: bool | None = None,
                 dropout: tuple = (0.2, 0.5),
                 bn_pool: tuple = (), pool_vjp: tuple = (),
                 gru_bwd: str | None = None, freeze_cnn: bool = False,
                 freeze_bn: bool = False, block1_quant: str = "conv1",
                 block1_tc: int = 48, block1_mode: str = "triple"):
        super().__init__()
        if freeze_cnn or freeze_bn:
            raise NotImplementedError(
                "freeze_cnn / freeze_bn are not ported yet (ROADMAP.md, "
                "Queue 1: the rest of the training surface, the freeze "
                "masks)")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("dtype must be torch.float32 or torch.bfloat16")
        if conv_mode is not None and dtype != torch.bfloat16:
            raise ValueError("the serving kernels (conv_mode 'bf16' or "
                             "'int8') run with dtype=bfloat16")
        self.sample_rate = sample_rate
        self.dtype = dtype
        self.conv_mode = conv_mode
        self.mel_config = cnn8rnn_mel_config(sample_rate)
        self.dropout = tuple(dropout)            # (after blocks, after mean)
        self._generator = None
        self.bn0 = nn.BatchNorm1d(64)
        for i, (cin, cout, _) in enumerate(_BLOCKS, start=1):
            setattr(self, f"conv_block{i}", ConvBlock(
                cin, cout, conv_mode, bn_pool=cout in bn_pool,
                pool_vjp=cout in pool_vjp, block1_quant=block1_quant,
                block1_tc=block1_tc, block1_mode=block1_mode))
        self.fc1 = nn.Linear(512, 512)
        self.rnn = BiGRU(512, 256, dtype=dtype, kernel=gru_kernel,
                         bwd=gru_bwd)

    def _dropout_generator(self, device: torch.device) -> torch.Generator:
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(torch.initial_seed())
        return self._generator

    def forward(self, input_dict: dict) -> dict:
        waveform = input_dict["waveform"]
        cfg = self.mel_config
        train = self.training
        if train and self.conv_mode is not None:
            raise ValueError("training runs the plain path: conv_mode=None")
        if self.dtype == torch.bfloat16:       # the kernel (frontend.py:229)
            x = fused_log_mel_spectrogram(waveform, cfg)    # [B, T, 64]
        else:
            x = log_mel_spectrogram(waveform, cfg)
        # bn0 over the mel axis: f32, per mel
        x = (batch_norm_train if train else batch_norm_eval)(x, self.bn0)
        x = x[..., None].to(self.dtype)                     # [B, T, 64, 1]
        gen = self._dropout_generator(x.device) if train else None
        p_block, p_mean = self.dropout if train else (0.0, 0.0)
        for i, (_, _, pool) in enumerate(_BLOCKS, start=1):
            x = dropout(getattr(self, f"conv_block{i}")(x, pool), p_block,
                        gen)
        # mean over mel in the blocks' dtype (f32 sum, as jnp.mean)
        x = x.float().mean(dim=2).to(self.dtype)            # [B, T/4, 512]
        x = dropout(x, p_mean, gen)
        x = torch.relu(F.linear(x.float(), self.fc1.weight, self.fc1.bias))
        x = self.rnn(x, dtype=torch.float32 if train else self.dtype)
        length = input_dict["waveform_len"] // cfg.hop_length + 1
        return {"embedding": x, "length": length // self.downsample_ratio}
