"""More retrieval audio towers: ResNet38, Wavegram-Logmel-Cnn14 and the
Audio Spectrogram Transformer.

Port of ``texttoaudiogrounding_tpu/models/retrieval_towers.py`` (reference
audio_text_retrieval_models/audio_encoder.py:188-865): the same
``{"clip_emb", "time_emb", "length"}`` contract as ``Cnn14``.  Layouts
are channel-last; the conv blocks pool ``"avg"`` on the plain path.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.device import place
from texttoaudiogrounding_tpu_torch.models.layers import (
    ConvBlock,
    Seeded,
    batch_norm,
    conv2d_cl,
    rank_stripes,
    spec_augment,
    spec_augment_stripes,
    xavier,
)
from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
    TextTowerConfig,
    TransformerLayer,
)
from texttoaudiogrounding_tpu_torch.models.retrieval import AudioTower
from texttoaudiogrounding_tpu_torch.ops.frontend import (
    LogMelConfig,
    log_mel_spectrogram,
)
from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import global_rows


def avg_pool_cl(x: torch.Tensor, window) -> torch.Tensor:
    """flax ``avg_pool`` (window = stride, "VALID") on ``[B, T, M, C]``."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


def _conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return xavier(nn.Conv2d(cin, cout, k, padding=k // 2, bias=False))


class ResnetBasicBlock(nn.Module):
    """PANNs ResNet basic block (JAX ``retrieval_towers.py:38-73``): a
    stride of 2 as an avg pool first, conv-BN-ReLU, dropout 0.1, conv-BN
    (``bn2`` starts at scale 0), the 1×1 conv + BN shortcut where the
    shape changes, ReLU of the sum."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.stride, self.use_downsample = stride, use_downsample
        self.conv1, self.bn1 = _conv(inplanes, planes), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes), nn.BatchNorm2d(planes)
        nn.init.zeros_(self.bn2.weight)
        if use_downsample:
            self.downsample_conv = _conv(inplanes, planes, 1)
            self.downsample_bn = nn.BatchNorm2d(planes)

    def forward(self, x: torch.Tensor, drop) -> torch.Tensor:
        train = self.training
        identity = out = x
        if self.stride == 2:
            out = avg_pool_cl(out, (2, 2))
        out = torch.relu(batch_norm(conv2d_cl(out, self.conv1), self.bn1,
                                    train))
        out = batch_norm(conv2d_cl(drop(out, 0.1), self.conv2), self.bn2,
                         train)
        if self.use_downsample:
            if self.stride == 2:
                identity = avg_pool_cl(identity, (2, 2))
            identity = batch_norm(conv2d_cl(identity, self.downsample_conv),
                                  self.downsample_bn, train)
        return torch.relu(out + identity)


_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class ResNet38(AudioTower):
    """PANNs ResNet38 (JAX ``retrieval_towers.py:76-120``): a ConvBlock
    stem, basic-block stages [3, 4, 6, 3] (64/128/256/512, modules
    ``layer{s}_block{i}``), an avg pool and ``conv_block_after1``
    (2048)."""

    def __init__(self, sample_rate: int = 32000, embed_dim: int = 2048,
                 downsample_ratio: int = 32, device="cuda"):
        super().__init__(sample_rate, embed_dim, downsample_ratio)
        self.conv_block1 = ConvBlock(1, 64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(_STAGES, start=1):
            for i in range(blocks):
                s = stride if i == 0 else 1
                down = i == 0 and (s != 1 or inplanes != planes)
                setattr(self, f"layer{stage}_block{i}", ResnetBasicBlock(
                    inplanes if i == 0 else planes, planes, s, down))
            inplanes = planes
        self.conv_block_after1 = ConvBlock(512, 2048)
        self.fc1 = xavier(nn.Linear(2048, 2048))
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        x = self._log_mel(input_dict)
        x = self._drop(self.conv_block1(x, (2, 2), pool_type="avg"), 0.2)
        for stage, (_, blocks, _) in enumerate(_STAGES, start=1):
            for i in range(blocks):
                x = getattr(self, f"layer{stage}_block{i}")(x, self._drop)
        x = self._drop(avg_pool_cl(x, (2, 2)), 0.2)
        x = self._drop(self.conv_block_after1(x, (1, 1), pool_type="avg"),
                       0.2)
        return self._clip(x.mean(dim=2), input_dict)


class ConvPreWavBlock(nn.Module):
    """The wavegram branch's 1-D block (JAX ``retrieval_towers.py:123-138``):
    two dilated (1, 2) 3-tap convs with BN and ReLU, then a max pool; on
    ``[B, N, C]``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        for i, (cin, dil) in enumerate(((in_channels, 1),
                                        (out_channels, 2)), start=1):
            setattr(self, f"conv{i}", xavier(nn.Conv1d(
                cin, out_channels, 3, padding=dil, dilation=dil,
                bias=False)))
            setattr(self, f"bn{i}", nn.BatchNorm1d(out_channels))

    def forward(self, x: torch.Tensor, pool_size: int) -> torch.Tensor:
        for i in (1, 2):
            x = getattr(self, f"conv{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = torch.relu(batch_norm(x, getattr(self, f"bn{i}"),
                                      self.training))
        return F.max_pool1d(x.transpose(1, 2), pool_size).transpose(1, 2)


class WavegramLogmelCnn14(AudioTower):
    """Wavegram + log-mel towers joined after the first conv block (JAX
    ``retrieval_towers.py:141-210``): the waveform through ``pre_conv0``
    (stride 5) and three ``ConvPreWavBlock`` s (÷320) folded to 32 × 4 and
    ``pre_block4``, concatenated over channels with the log-mel's
    ``conv_block1``, then blocks 2-6 as ``Cnn14``."""

    def __init__(self, sample_rate: int = 32000, embed_dim: int = 2048,
                 downsample_ratio: int = 32, device="cuda"):
        super().__init__(sample_rate, embed_dim, downsample_ratio)
        self.pre_conv0 = xavier(nn.Conv1d(1, 64, 11, stride=5, padding=5,
                                           bias=False))
        self.pre_bn0 = nn.BatchNorm1d(64)
        self.pre_block1 = ConvPreWavBlock(64, 64)
        self.pre_block2 = ConvPreWavBlock(64, 128)
        self.pre_block3 = ConvPreWavBlock(128, 128)
        self.pre_block4 = ConvBlock(4, 64)
        self.conv_block1 = ConvBlock(1, 64)
        for i, (cin, cout) in ((2, (128, 128)), (3, (128, 256)),
                               (4, (256, 512)), (5, (512, 1024)),
                               (6, (1024, 2048))):
            setattr(self, f"conv_block{i}", ConvBlock(cin, cout))
        self.fc1 = xavier(nn.Linear(2048, 2048))
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        a = self.pre_conv0(input_dict["waveform"][:, None]).transpose(1, 2)
        a = torch.relu(batch_norm(a, self.pre_bn0, self.training))
        for i in (1, 2, 3):
            a = getattr(self, f"pre_block{i}")(a, 4)
        b, t, _ = a.shape
        a = a.reshape(b, t, 4, 32).transpose(2, 3)          # [B, T, 32, 4]
        a = self.pre_block4(a, (2, 1), pool_type="avg")
        x = self.conv_block1(self._log_mel(input_dict), (2, 2),
                             pool_type="avg")
        t = min(x.shape[1], a.shape[1])
        x = self._drop(torch.cat([x[:, :t], a[:, :t, :x.shape[2]]], dim=-1),
                       0.2)
        for i in (2, 3, 4, 5, 6):
            x = self._drop(getattr(self, f"conv_block{i}")(
                x, (2, 2) if i < 6 else (1, 1), pool_type="avg"), 0.2)
        return self._clip(x.mean(dim=2), input_dict)


class AudioSpectrogramTransformer(Seeded):
    """AST, a ViT over overlapping 16×16 patches of a 128-mel log-mel (JAX
    ``retrieval_towers.py:213-280``; f_min 50, f_max 14,000 at 32 kHz):
    ``init_bn``, ``patch_embed`` (stride ``(tstride, fstride)``),
    ``cls_token`` and ``dist_token``, ``pos_embed``, ``layer_{i}``
    (:class:`TransformerLayer`, LayerNorm epsilon 1e-6, no dropout inside)
    and ``norm``; ``clip_emb`` the mean of the two tokens, ``time_emb``
    the patch tokens' mean over frequency.  ``input_tdim`` (frames) sizes
    ``pos_embed``, whose shape the JAX module takes from its first input:
    1001 frames is a 10 s clip at 32 kHz."""

    def __init__(self, sample_rate: int = 32000, fstride: int = 10,
                 tstride: int = 10, input_fdim: int = 128,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 embed_dim: int = 768, input_tdim: int = 1001,
                 device="cuda"):
        super().__init__()
        self.sample_rate, self.embed_dim = sample_rate, embed_dim
        self.num_layers = num_layers
        self.mel_config = LogMelConfig(
            sample_rate=sample_rate, n_fft=32 * sample_rate // 1000,
            win_length=32 * sample_rate // 1000,
            hop_length=10 * sample_rate // 1000, n_mels=input_fdim,
            f_min=50.0,
            f_max=14000.0 if sample_rate == 32000 else sample_rate / 2,
            norm="slaney", mel_scale="slaney")
        self.init_bn = nn.BatchNorm1d(input_fdim)
        self.patch_embed = nn.Conv2d(1, hidden_size, 16,
                                     stride=(tstride, fstride))
        self.patches = ((input_tdim - 16) // tstride + 1,
                        (input_fdim - 16) // fstride + 1)
        tokens = self.patches[0] * self.patches[1] + 2
        for name, shape in (("cls_token", (1, 1, hidden_size)),
                            ("dist_token", (1, 1, hidden_size)),
                            ("pos_embed", (1, tokens, hidden_size))):
            setattr(self, name, nn.Parameter(torch.randn(shape) * 0.02))
        cfg = TextTowerConfig(hidden_size=hidden_size, num_layers=num_layers,
                              num_heads=num_heads,
                              intermediate_size=mlp_dim, dropout=0.0,
                              layer_norm_eps=1e-6)
        for i in range(num_layers):
            setattr(self, f"layer_{i}", TransformerLayer(cfg))
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        place(self, device)

    def forward(self, input_dict: dict) -> dict:
        x = log_mel_spectrogram(input_dict["waveform"], self.mel_config)
        x = batch_norm(x, self.init_bn, self.training)
        if self.training and input_dict.get("specaug", False):
            b, t, m = x.shape
            x = spec_augment(x, rank_stripes(spec_augment_stripes(
                self._dropout_generator(x.device), global_rows(b), t, m)))
        x = self.patch_embed(x[:, None])                   # [B, H, tp, fp]
        b, h, tp, fp = x.shape
        if (tp, fp) != self.patches:
            raise ValueError(f"{tp} x {fp} patches; pos_embed is sized for "
                             f"{self.patches[0]} x {self.patches[1]} "
                             f"(input_tdim)")
        tokens = torch.cat([self.cls_token.expand(b, 1, h),
                            self.dist_token.expand(b, 1, h),
                            x.permute(0, 2, 3, 1).reshape(b, tp * fp, h)],
                           dim=1) + self.pos_embed
        tokens = self._drop(tokens, 0.1)
        mask = torch.ones(tokens.shape[:2], dtype=torch.bool,
                          device=tokens.device)
        for i in range(self.num_layers):
            tokens = getattr(self, f"layer_{i}")(tokens, mask)
        tokens = self.norm(tokens)
        return {"clip_emb": (tokens[:, 0] + tokens[:, 1]) / 2,
                "time_emb": tokens[:, 2:].reshape(b, tp, fp, h).mean(dim=2),
                "length": torch.full((b,), tp, dtype=torch.int32,
                                     device=tokens.device)}
