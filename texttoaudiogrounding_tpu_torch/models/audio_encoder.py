"""Audio encoders: waveform → frame embeddings + frame lengths.

Port of ``texttoaudiogrounding_tpu/models/audio_encoder.py:60-144``
(``Cnn8Rnn``, reference models/audio_encoder.py:89-232): log-mel (64
slaney mels) → bn0 over the mel axis → 4 PANNs conv blocks
(64→128→256→512, avg+max pools, time ÷4, mel ÷16) → mean over mel → FC512
+ ReLU → BiGRU(256×2); and of ``:147-190`` (``CrnnEncoder``, the CDur
encoder, reference :25-86).  ``length = (waveform_len // hop + 1) // 4``.

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

Three more switches of the JAX environment are arguments here:
``logmel_kernel`` is ``TTG_PALLAS_FRONTEND`` (True / False force the
log-mel kernel on or off; None, the default, takes it in bf16 only);
``block1_pair=False`` is ``TTG_FUSED_B1=0`` (in serving, block 1 leaves its
pair kernel for the plain path, in bf16 with the running statistics,
while blocks 2-4 keep theirs); ``remat_blocks`` is ``TTG_TRAIN_REMAT``
(the ids, 1-4, of the conv blocks whose activations the train step
recomputes in its backward, ``models/remat.py``; the dropout after a
block stays outside it, as in JAX).

``bn_pool`` and ``pool_vjp`` list the out-channels of the blocks that run
the pool kernels (``ConvBlock``); ``gru_bwd`` is ``BiGRU``'s ``bwd``:
``"bf16"`` picks the bf16 trainable GRU, ``"v2"`` / ``"v3"`` the hoisted
f32 backward.  ``freeze_cnn`` is read by the optimizer's freeze mask
(``training/optim.py:freeze_mask_from_model``: everything but ``rnn``
stays where it is); ``freeze_bn`` makes bn0 and every block's BatchNorms
use their running statistics also in train mode (JAX ``:93``), so that
the opt-in ``bn_pool`` kernel, which computes batch statistics, steps
aside there.  The BiGRU is f32 in train mode and
in the module's dtype in eval mode (``audio_encoder.py:133``): in bf16,
the grouped loop with bf16 operands and carry unless ``gru_kernel``.

In train mode (``audio_encoder.py:85-144``) bn0 and the blocks'
BatchNorms use batch statistics, ``Dropout(0.2)`` follows each block and
``Dropout(0.5)`` the mel mean, with masks drawn from the module's own
``torch.Generator`` (seeded, when first used, from the torch seed: the
trainer's config seed).  In train mode ``Cnn8Rnn`` also takes the
class-mapping augmentations of JAX ``:98-103, 138-143``: with ``specaug``
true in the input, SpecAugment after bn0 (``layers.spec_augment``, its
stripes drawn from the same generator for the global batch and cut to
the rank's rows, ``layers.rank_stripes``), and with ``mixup_lambda [B]`` in
the input, mixup of the log-mel after it (``layers.do_mixup``: the batch
halves before the conv blocks) and of the length, which stays float
(``λ·l0 + (1-λ)·l1``: a length of 12.6 keeps 13 frames through
``generate_length_mask``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.models.layers import (
    BiGRU,
    CDurBlock,
    ConvBlock,
    Seeded as _Encoder,
    batch_norm_eval,
    batch_norm_train,
    do_mixup,
    dropout,
    lp_pool_2d,
    rank_stripes,
    spec_augment,
    spec_augment_stripes,
)
from texttoaudiogrounding_tpu_torch.models.remat import checkpointed
from texttoaudiogrounding_tpu_torch.ops.frontend import (
    cdur_mel_config,
    cnn8rnn_mel_config,
    log_mel_spectrogram,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.logmel import (
    fused_log_mel_spectrogram,
)
from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import global_rows

_BLOCKS = ((1, 64, (2, 2)), (64, 128, (2, 2)), (128, 256, (1, 2)),
           (256, 512, (1, 2)))


class Cnn8Rnn(_Encoder):
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
                 block1_tc: int = 48, block1_mode: str = "triple",
                 logmel_kernel: bool | None = None, block1_pair: bool = True,
                 remat_blocks: tuple = ()):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("dtype must be torch.float32 or torch.bfloat16")
        if not set(remat_blocks) <= {1, 2, 3, 4}:
            raise ValueError("remat_blocks lists conv block ids 1-4")
        self.logmel_kernel = logmel_kernel
        self.remat_blocks = tuple(remat_blocks)
        if conv_mode is not None and dtype != torch.bfloat16:
            raise ValueError("the serving kernels (conv_mode 'bf16' or "
                             "'int8') run with dtype=bfloat16")
        self.sample_rate = sample_rate
        self.dtype = dtype
        self.conv_mode = conv_mode
        self.freeze_cnn, self.freeze_bn = freeze_cnn, freeze_bn
        self.mel_config = cnn8rnn_mel_config(sample_rate)
        self.dropout = tuple(dropout)            # (after blocks, after mean)
        self.bn0 = nn.BatchNorm1d(64)
        for i, (cin, cout, _) in enumerate(_BLOCKS, start=1):
            setattr(self, f"conv_block{i}", ConvBlock(
                cin, cout, conv_mode, bn_pool=cout in bn_pool,
                pool_vjp=cout in pool_vjp, block1_quant=block1_quant,
                block1_tc=block1_tc, block1_mode=block1_mode,
                pair_kernel=block1_pair or i > 1))
        self.fc1 = nn.Linear(512, 512)
        self.rnn = BiGRU(512, 256, dtype=dtype, kernel=gru_kernel,
                         bwd=gru_bwd)

    def forward(self, input_dict: dict) -> dict:
        waveform = input_dict["waveform"]
        cfg = self.mel_config
        train = self.training
        bn_train = train and not self.freeze_bn
        if train and self.conv_mode is not None:
            raise ValueError("training runs the plain path: conv_mode=None")
        kernel = (self.dtype == torch.bfloat16 if self.logmel_kernel is None
                  else self.logmel_kernel)
        if kernel:                             # the kernel (frontend.py:229)
            x = fused_log_mel_spectrogram(waveform, cfg)    # [B, T, 64]
        else:
            x = log_mel_spectrogram(waveform, cfg)
        # bn0 over the mel axis: f32, per mel
        x = (batch_norm_train if bn_train else batch_norm_eval)(x, self.bn0)
        gen = self._dropout_generator(x.device) if train else None
        if train and input_dict.get("specaug", False):
            b, t, m = x.shape
            x = spec_augment(x, rank_stripes(spec_augment_stripes(
                gen, global_rows(b), t, m)))
        mixup_lambda = input_dict.get("mixup_lambda") if train else None
        if mixup_lambda is not None:
            x = do_mixup(x, mixup_lambda)
        x = x[..., None].to(self.dtype)                     # [B, T, 64, 1]
        p_block, p_mean = self.dropout if train else (0.0, 0.0)
        for i, (_, _, pool) in enumerate(_BLOCKS, start=1):
            block = getattr(self, f"conv_block{i}")
            if train and i in self.remat_blocks:
                x = checkpointed(block, x, pool, bn_train)
            else:
                x = block(x, pool, bn_train)
            x = dropout(x, p_block, gen)
        # mean over mel in the blocks' dtype (f32 sum, as jnp.mean)
        x = x.float().mean(dim=2).to(self.dtype)            # [B, T/4, 512]
        x = dropout(x, p_mean, gen)
        x = torch.relu(self.fc1(x.float()))
        x = self.rnn(x, dtype=torch.float32 if train else self.dtype)
        length = (input_dict["waveform_len"] // cfg.hop_length + 1
                  ) // self.downsample_ratio
        if mixup_lambda is not None:
            length = do_mixup(length.float(), mixup_lambda)
        return {"embedding": x, "length": length}


# CDur's blocks: (in, out) channels, then the LP pool after the block
_CDUR_BLOCKS = (((1, 32), (2, 4)), ((32, 128), None), ((128, 128), (2, 4)),
                ((128, 128), None), ((128, 128), (1, 4)))


class CrnnEncoder(_Encoder):
    """The CDur CRNN encoder (JAX ``audio_encoder.py:147-190``): the CDur
    log-mel (n_fft 2048, 40 ms window, 20 ms hop, 64 HTK mels, f32 as one
    matrix product: no TPU kernel computes it), 5 :class:`CDurBlock` s
    (1→32→128→128→128→128) with LP pools (p = 4) of (2, 4) after blocks 1
    and 3 and (1, 4) after block 5, ``Dropout(0.3)`` in train mode (masks
    from the module's generator), then ``BiGRU(embed_dim // 2)`` in f32
    over the 128 channels × 1 mel, through the GRU kernels.  Time ÷4:
    0.08 s frames.  The modules are ``block1`` ... ``block5`` (``bn``,
    ``conv``) and ``gru``."""

    downsample_ratio = 4
    dropout = 0.3

    def __init__(self, sample_rate: int = 32000, embed_dim: int = 256):
        super().__init__()
        self.sample_rate = sample_rate
        self.embed_dim = embed_dim
        self.time_resolution = 20 * self.downsample_ratio / 1000.0
        self.mel_config = cdur_mel_config(sample_rate)
        for i, ((cin, cout), _) in enumerate(_CDUR_BLOCKS, start=1):
            setattr(self, f"block{i}", CDurBlock(cin, cout))
        mels = self.mel_config.n_mels // 4 // 4 // 4     # the mel pools
        self.gru = BiGRU(128 * mels, embed_dim // 2)

    def forward(self, input_dict: dict) -> dict:
        cfg = self.mel_config
        x = log_mel_spectrogram(input_dict["waveform"], cfg)[..., None]
        for i, (_, pool) in enumerate(_CDUR_BLOCKS, start=1):
            x = getattr(self, f"block{i}")(x)
            if pool is not None:
                x = lp_pool_2d(x, 4, pool)
        if self.training:
            x = dropout(x, self.dropout, self._dropout_generator(x.device))
        b, t, m, c = x.shape
        x = self.gru(x.reshape(b, t, m * c), dtype=torch.float32)
        length = input_dict["waveform_len"] // cfg.hop_length + 1
        return {"embedding": x, "length": length // self.downsample_ratio}
