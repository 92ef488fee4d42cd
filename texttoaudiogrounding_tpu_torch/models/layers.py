"""Shared building blocks: the PANNs ConvBlock, the CDur block with its LP
pool, the grouped-scan BiGRU, SpecAugment and mixup, dropout from a
module's generator, and the text encoders' recurrent layers (``GRU``,
``RNN``, ``LSTM``, JAX ``layers.py:344-632``) and ``PositionalEncoding``.

Ports of ``texttoaudiogrounding_tpu/models/layers.py:21-292``
(``_FusedBNPool``, ConvBlock), ``:295-325`` (``CDurBlock``,
``lp_pool_2d``), ``:425-543`` (BiGRU) and ``:635-670`` (``spec_augment``,
here split into the draws and their masks, and ``do_mixup``).  Activations are
channel-last, ``[B, T, M, C]``, as in the JAX package; parameters and
state-dict names follow the reference torch modules (``conv1.weight`` is
``[Cout, Cin, 3, 3]``, BN keeps running statistics, the GRU is named like
``nn.GRU``), which is the layout ``weights.from_jax_variables`` produces.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.models import remat
from texttoaudiogrounding_tpu_torch.ops.kernels import (
    conv_block1_pair,
    conv_block_wino,
    gru,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.bn_pool import (
    bn_relu_dual_pool,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
    fold_bn,
    fused_double_conv_pool,
    kernel_weights,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block1_pair import (
    fused_block1_pair,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block_pair import (
    fused_block2_pair,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.dual_pool import (
    POOLS,
    dual_pool_relu,
)
from texttoaudiogrounding_tpu_torch.parallel import kernel_shard

CONV_MODES = (None, "bf16", "int8")
# block 1's modes under conv_mode="int8" (the JAX TTG_B1_QUANT: "mixed" or
# "conv1", "1", "0") → fused_block1_pair's quantize
BLOCK1_QUANT = {"conv1": "conv1", "int8": True, "bf16": False}
GRU_BWD = (None, "bf16", "v2", "v3")
# ConvBlock's pools (JAX ``layers.py:285-294``)
POOL_TYPES = ("avg+max", "avg", "max")
# The type the train-mode BatchNorms sum their statistics in: f32, as flax
# does.  A comparison of two orders of summation (N ranks against one) may
# set float64 to take the sums' rounding out of it.
STATS_DTYPE = torch.float32


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - p``, scale kept
    values by ``1 / (1 - p)``; the mask comes from ``generator``, drawn
    for the global batch under an active ``data`` axis and cut to the
    rank's rows."""
    if p == 0.0:
        return x
    keep = kernel_shard.local_rows(kernel_shard.global_like(x).bernoulli_(
        1.0 - p, generator=generator))
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


class Seeded(nn.Module):
    """The dropout masks' ``torch.Generator``, seeded, when first used on a
    device, from the torch seed (the trainer's config seed)."""

    _generator = None

    def _dropout_generator(self, device: torch.device) -> torch.Generator:
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(torch.initial_seed())
        return self._generator

    def _drop(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """:func:`dropout` at rate ``p`` in train mode, else ``x``."""
        if not self.training:
            return x
        return dropout(x, p, self._dropout_generator(x.device))


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d
                    ) -> torch.Tensor:
    """Running-statistics BN over the last axis, in flax's arithmetic:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x - bn.running_mean) * mul + bn.bias


def update_running(bn: nn.BatchNorm1d | nn.BatchNorm2d, mean: torch.Tensor,
                   var: torch.Tensor) -> None:
    """flax's running-statistics rule: ``0.9 · running + 0.1 · batch``;
    not in the backward's recompute of a rematerialized forward
    (``models/remat.py``), whose forward already moved them."""
    if remat.recomputing():
        return
    with torch.no_grad():
        bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
        bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d
                     ) -> torch.Tensor:
    """Batch-statistics BN over the last axis, in flax's arithmetic
    (``layers.py:265``): f32 statistics, ``var = mean(x²) - mean(x)²``
    (biased, clipped at 0), the running statistics moved by
    :func:`update_running` (``nn.BatchNorm2d`` would keep the unbiased
    variance).  The result is f32 also for bf16 ``x``, as flax's
    ``_normalize`` promotes ``x - mean``; the caller casts it.  Under an
    active ``data`` axis (``parallel/kernel_shard.py``) the sums of x and
    x² are those of the global batch, summed over the ranks with their
    gradients, as GSPMD reduces the JAX step's statistics.  The sums are
    taken in :data:`STATS_DTYPE`."""
    dims = tuple(range(x.dim() - 1))
    xf = x.to(STATS_DTYPE)
    if kernel_shard.active_data_axis() is None:
        mean = xf.mean(dim=dims)
        var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
    else:
        count = kernel_shard.global_rows(xf.shape[0]) * math.prod(
            xf.shape[1:-1])
        sums = kernel_shard.global_sums(torch.stack(
            [xf.sum(dim=dims), (xf * xf).sum(dim=dims)]))
        mean = sums[0] / count
        var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
    mean, var = mean.float(), var.float()
    update_running(bn, mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean) * mul + bn.bias


class ConvBlock(nn.Module):
    """PANNs double-conv block: (conv3x3 → BN → ReLU) × 2 → avg+max pool.

    ``conv_mode=None`` is the plain f32 path (the reference);
    ``"bf16"`` / ``"int8"`` route the block through the hand-written
    kernels with the BN folded into their epilogues, as the JAX serving
    path routes it under ``TTG_FUSED_CONV``:

    * Cin = 1, 64 mels, pool (2, 2) → block 1 (``fused_block1_pair``,
      unless ``pair_kernel`` is False, the JAX ``TTG_FUSED_B1=0``: then the
      plain path in bf16 with the running statistics;
      int8 serving runs it in the mode ``block1_quant`` names, as
      ``TTG_B1_QUANT`` does: ``"conv1"``, int8 conv1 and bf16 conv2, the
      default; ``"int8"``, both convs in int8, y1 requantized per chunk of
      ``block1_tc`` frames (``TTG_B1_TC``); ``"bf16"``; bf16 serving runs
      it in bf16), with the staging ``block1_mode`` names (``TTG_B1_MODE``:
      ``"triple"`` or ``"single"``, whose y1 scale window differs under
      ``"int8"``);
    * Cin = 64, Cout a multiple of 128, pool (2, 2) → block 2
      (``fused_block2_pair``);
    * with ``wino`` (the JAX ``TTG_WINO=1``), Cin ≥ 128, pool (2, 2), M
      even and a chunking both TPU kernels accept (``layers.py:207-245``)
      → the Winograd block (``fused_block_wino``);
    * otherwise → ``fused_double_conv_pool`` (blocks 3 and 4).

    The kernels' weights (HWIO, BN folded, quantized and laid out for the
    card) are made once and kept until a parameter or buffer changes.

    On the plain path the block computes in x's type (f32, or bf16 in the
    mixed-precision mode): convolutions with operands in that type, BN with
    f32 statistics and f32 normalisation cast back to it, ReLU and pools in
    it.  Two opt-ins replace the segment after conv2 with a kernel, as
    ``TTG_BN_POOL`` / ``TTG_POOL_VJP`` list a block's channels in the JAX
    package (``layers.py:252-280``):

    * ``bn_pool``: train-mode BN2 + ReLU + pool in one custom VJP
      (``ops/kernels/bn_pool.py``), with batch statistics only; wins over
      ``pool_vjp``;
    * ``pool_vjp``: ReLU + pool after BN2 with the mask-recompute backward
      (``ops/kernels/dual_pool.py``), in train and eval mode.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 conv_mode: str | None = None, bn_pool: bool = False,
                 pool_vjp: bool = False, block1_quant: str = "conv1",
                 block1_tc: int = 48, block1_mode: str = "triple",
                 wino: bool = False, pair_kernel: bool = True):
        super().__init__()
        self.pair_kernel = pair_kernel
        if conv_mode not in CONV_MODES:
            raise ValueError(f"conv_mode must be one of {CONV_MODES}")
        self.conv_mode = conv_mode
        if block1_quant not in BLOCK1_QUANT:
            raise ValueError(f"block1_quant must be one of "
                             f"{tuple(BLOCK1_QUANT)}")
        conv_block1_pair.check_mode(BLOCK1_QUANT[block1_quant], block1_tc,
                                    block1_mode)
        self.block1_quant, self.block1_tc = block1_quant, block1_tc
        self.block1_mode, self.wino = block1_mode, wino
        self.bn_pool = bn_pool
        self.pool_vjp = pool_vjp
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.bn2 = nn.BatchNorm2d(out_channels)
        self._kept = (None, None)

    def _kernel_weights(self, kind: str, quantize) -> tuple:
        """(w1, ab1, w2, ab2, the layout of the ``kind`` kernel —
        ``"block1"``, ``"wino"`` or ``"direct"`` — or None on the CPU) for
        the kernel's ``quantize`` mode, made anew only when a tensor they
        come from is replaced or written in place (``load_state_dict``,
        ``.to``)."""
        src = (self.conv1.weight, self.conv2.weight) + tuple(
            t for bn in (self.bn1, self.bn2)
            for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var))
        key = (kind, quantize) + tuple(
            (t.data_ptr(), t._version) for t in src)
        if self._kept[0] != key:
            with torch.no_grad():
                w1 = self.conv1.weight.permute(2, 3, 1, 0)   # HWIO
                w2 = self.conv2.weight.permute(2, 3, 1, 0)
                ab1, ab2 = (fold_bn(bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, bn.eps)
                            for bn in (self.bn1, self.bn2))
                prep = None
                if w1.is_cuda and kind == "block1":
                    prep = conv_block1_pair.kernel_weights(
                        w1, ab1, w2, ab2, quantize)
                elif w1.is_cuda and kind == "wino":
                    prep = conv_block_wino.wino_weights(
                        w1, ab1, w2, ab2, quantize)
                elif w1.is_cuda:
                    prep = kernel_weights(w1, ab1, w2, ab2, quantize)
            self._kept = (key, (w1, ab1, w2, ab2, prep))
        return self._kept[1]

    @staticmethod
    def _pool_kernel_ok(y: torch.Tensor, pool) -> bool:
        """The JAX gate of the pool kernels (``_chan_flag_ok``,
        ``_pool_vjp_shape``, ``layers.py:73-118``): pool (2, 2) or (1, 2), M
        even, at least one pooled row, and C a multiple of 128 or block 1's
        M = C = 64 with pool (2, 2).  The JAX gate also turns a shape down
        when its TPU chunk picker finds no chunk (a prime T, say); the
        card's kernels take any T, and compute the same function, so the
        port routes those shapes to them."""
        _, t, m, c = y.shape
        if pool not in POOLS or m % 2 or t // pool[0] == 0:
            return False
        return c % 128 == 0 or (m == 64 and c == 64 and pool == (2, 2))

    def _plain(self, x: torch.Tensor, pool_size,
               bn_train: bool | None = None,
               pool_type: str = "avg+max") -> torch.Tensor:
        if bn_train is None:
            bn_train = self.training
        norm = batch_norm_train if bn_train else batch_norm_eval
        dt = x.dtype
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt),
                         padding=1).permute(0, 2, 3, 1)
            if (bn is self.bn2 and pool_type == "avg+max"
                    and self._pool_kernel_ok(y, pool_size)):
                if self.bn_pool and bn_train:
                    out, mean, var = bn_relu_dual_pool(
                        y, bn.weight, bn.bias, pool_size, bn.eps)
                    update_running(bn, mean, var)
                    return out
                if self.pool_vjp:
                    return dual_pool_relu(norm(y, bn).to(dt), pool_size)
            x = torch.relu(norm(y, bn).to(dt))
        return pool_2d(x, pool_size, pool_type)

    def _served(self, x: torch.Tensor, pool: tuple) -> torch.Tensor:
        quantize = self.conv_mode == "int8"
        x = x.to(torch.bfloat16).contiguous()
        cin, cout = x.shape[3], self.conv1.out_channels
        if cin == 1 and cout == 64 and x.shape[2] == 64 and pool == (2, 2):
            if not self.pair_kernel:
                return self._plain(x, pool, bn_train=False)
            mode = BLOCK1_QUANT[self.block1_quant] if quantize else False
            *w, prep = self._kernel_weights("block1", mode)
            return fused_block1_pair(x[..., 0].contiguous(), *w,
                                     quantize=mode, tc=self.block1_tc,
                                     mode=self.block1_mode, prepared=prep)
        if (cin == 64 and cout % 128 == 0 and pool == (2, 2)
                and x.shape[2] % 2 == 0):
            *w, prep = self._kernel_weights("direct", quantize)
            return fused_block2_pair(x, *w, quantize=quantize, prepared=prep)
        if self.wino and conv_block_wino.routes(x.shape, cout, pool,
                                                quantize):
            *w, prep = self._kernel_weights("wino", quantize)
            return conv_block_wino.fused_block_wino(
                x, *w, quantize=quantize, prepared=prep)
        *w, prep = self._kernel_weights("direct", quantize)
        return fused_double_conv_pool(x, *w, pool, quantize=quantize,
                                      prepared=prep)

    def forward(self, x: torch.Tensor, pool_size=(2, 2),
                bn_train: bool | None = None,
                pool_type: str = "avg+max") -> torch.Tensor:
        """x ``[B, T, M, Cin]`` → ``[B, T // pt, M // pm, Cout]``.  In
        train mode the block runs the plain path (the JAX package runs its
        train-mode convolutions in XLA), through the pool kernels where
        they are opted in, with batch statistics unless ``bn_train`` is
        False (``Cnn8Rnn(freeze_bn=True)``: the running statistics, and no
        ``bn_pool``, whose kernel computes the batch statistics; JAX routes
        it on ``bn_train``, ``layers.py:94-100``).  None follows the mode.
        ``pool_type`` (``"avg+max"``, ``"avg"`` or ``"max"``) is read by
        the plain path; the serving kernels pool ``"avg+max"`` only, as the
        JAX fused routes do (``layers.py:125-126``)."""
        if pool_type not in POOL_TYPES:
            raise ValueError(f"pool_type must be one of {POOL_TYPES}")
        if self.training and self.conv_mode is not None:
            raise ValueError("train mode runs the plain path: conv_mode=None")
        if self.conv_mode is None:
            return self._plain(x, tuple(pool_size), bn_train, pool_type)
        if pool_type != "avg+max":
            raise ValueError("the serving kernels pool 'avg+max' only")
        return self._served(x, tuple(pool_size))


def pool_2d(x: torch.Tensor, pool_size, pool_type: str = "avg+max"
            ) -> torch.Tensor:
    """flax's ``avg_pool`` / ``max_pool`` (or their sum, ``"avg+max"``)
    over non-overlapping ``pool_size`` windows of a channel-last
    ``[B, T, M, C]``, in x's type."""
    mx = (F.max_pool2d(x.permute(0, 3, 1, 2), pool_size).permute(0, 2, 3, 1)
          if pool_type != "avg" else None)
    if pool_type == "max":
        return mx
    dt = x.dtype
    if dt == torch.float32:
        avg = F.avg_pool2d(x.permute(0, 3, 1, 2), pool_size).permute(
            0, 2, 3, 1)
        return avg if mx is None else avg + mx
    # flax's avg_pool in bf16 is XLA's reduce_window: the window sum
    # rounds after every add, in window order (F.avg_pool2d would sum in
    # f32 and round once)
    kt, km = pool_size
    b, t, m, c = x.shape
    v = x[:, :t // kt * kt, :m // km * km].reshape(
        b, t // kt, kt, m // km, km, c)
    s = v[:, :, 0, :, 0]
    for k in range(1, kt * km):
        s = s + v[:, :, k // km, :, k % km]
    return s / (kt * km) if mx is None else s / (kt * km) + mx


class CDurBlock(nn.Module):
    """CDur block (JAX ``layers.py:295-310``): BN over the *input* channels,
    then a 3×3 convolution without bias, then LeakyReLU(0.1), channel-last
    ``[B, T, M, Cin] → [B, T, M, Cout]``.  In train mode the BN takes the
    batch statistics in flax's arithmetic and moves the running ones
    (:func:`batch_norm_train`), else it uses the running statistics."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(in_channels)
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                              bias=False)
        # the JAX tree's initialiser: kaiming-normal over fan-in
        nn.init.kaiming_normal_(self.conv.weight, nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (batch_norm_train if self.training else batch_norm_eval)(
            x, self.bn)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.conv.weight, padding=1)
        return F.leaky_relu(y.permute(0, 2, 3, 1), 0.1)


def conv2d_cl(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` ("SAME" padding) on a channel-last ``[B, T, M, C]``."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, bn: nn.Module, train: bool) -> torch.Tensor:
    """BN over the last axis, with batch statistics in train mode."""
    return (batch_norm_train if train else batch_norm_eval)(x, bn)


def xavier(module: nn.Module) -> nn.Module:
    """``module`` with flax's ``xavier_uniform`` weight and zero bias."""
    nn.init.xavier_uniform_(module.weight)
    if module.bias is not None:
        nn.init.zeros_(module.bias)
    return module


def lp_pool_2d(x: torch.Tensor, norm_type: float, window) -> torch.Tensor:
    """``nn.LPPool2d`` on channel-last ``[B, T, M, C]`` in the JAX
    package's formula (``layers.py:313-325``): ``(Σ |x|^p)^(1/p)`` over
    non-overlapping ``window``s, the spatial axes floor-divided.
    ``F.lp_pool2d`` computes another formula (an average scaled by the
    window size, ``sign · relu`` around the root), whose rounding and
    gradient at a zero sum differ."""
    kt, km = window
    b, t, m, c = x.shape
    p = float(norm_type)
    xp = torch.pow(torch.abs(x[:, :t // kt * kt, :m // km * km]), p)
    summed = xp.reshape(b, t // kt, kt, m // km, km, c).sum(dim=(2, 4))
    return torch.pow(summed, 1.0 / p)


def _stripes(generator: torch.Generator, batch: int, num: int,
             drop_width: int, total: int, device) -> tuple:
    """``num`` stripes a row: width ~ U[0, drop_width), begin ~ U[0,
    max(total - width, 1))."""
    width = torch.randint(0, drop_width, (batch, num), generator=generator,
                          device=device)
    span = torch.clamp_min(total - width, 1)
    begin = (torch.rand((batch, num), generator=generator, device=device)
             * span).long().clamp_max(span - 1)
    return begin, width


def spec_augment_stripes(generator: torch.Generator, batch: int,
                         frames: int, mels: int, time_drop_width: int = 64,
                         time_stripes_num: int = 2, freq_drop_width: int = 8,
                         freq_stripes_num: int = 2, device=None) -> dict:
    """The random part of SpecAugment (JAX ``layers.py:635-660``,
    torchlibrosa's ``SpecAugmentation`` law): ``{"time": (begin, width),
    "freq": (begin, width)}``, each ``[batch, stripes]`` int64, drawn from
    ``generator``."""
    device = generator.device if device is None else device
    return {"time": _stripes(generator, batch, time_stripes_num,
                             time_drop_width, frames, device),
            "freq": _stripes(generator, batch, freq_stripes_num,
                             freq_drop_width, mels, device)}


def rank_stripes(stripes: dict) -> dict:
    """Stripes drawn for the global batch (:func:`spec_augment_stripes` at
    ``kernel_shard.global_rows(b)`` rows) cut to the rank's rows, as
    dropout's masks are, so that N ranks draw what one rank draws; as they
    are outside an active ``data`` axis."""
    return {k: tuple(kernel_shard.local_rows(t) for t in pair)
            for k, pair in stripes.items()}


def stripe_keep(begin: torch.Tensor, width: torch.Tensor,
                total: int) -> torch.Tensor:
    """``[B, total]`` bool, False inside any of a row's stripes."""
    idx = torch.arange(total, device=begin.device)[None, None, :]
    hit = (idx >= begin[..., None]) & (idx < (begin + width)[..., None])
    return ~hit.any(dim=1)


def spec_augment(x: torch.Tensor, stripes: dict) -> torch.Tensor:
    """Zero the ``stripes`` (:func:`spec_augment_stripes`) of a log-mel
    ``x [B, T, M]``: ``x · time_keep · freq_keep``."""
    _, t, m = x.shape
    tkeep = stripe_keep(*stripes["time"], t).to(x.dtype)
    fkeep = stripe_keep(*stripes["freq"], m).to(x.dtype)
    return x * tkeep[:, :, None] * fkeep[:, None, :]


def do_mixup(x: torch.Tensor, mixup_lambda: torch.Tensor) -> torch.Tensor:
    """Even rows mixed with odd ones, ``x[0::2]·λ[0::2] + x[1::2]·λ[1::2]``
    in ``x``'s dtype; halves the batch (JAX ``layers.py:663-670``).  Under
    an active ``data`` axis ``x`` and ``mixup_lambda`` are the rank's rows
    of the global batch: with an even count each rank mixes its own rows;
    with an odd one a pair spans two ranks, and the rank mixes the global
    batch's pairs whose even row it holds (``kernel_shard.mixup_pairs``),
    whose counts differ between the ranks, down to none: that layout
    becomes the axis's for the rest of the forward
    (``kernel_shard.set_rows``)."""
    axis = kernel_shard.active_data_axis()
    if x.shape[0] % 2 and axis is not None:
        out = kernel_shard.mixup_pairs(x, mixup_lambda)
        kernel_shard.set_rows(kernel_shard.mixup_rows(x.shape[0], axis))
        return out
    lam = mixup_lambda.to(x.dtype)
    lam = lam.reshape(lam.shape + (1,) * (x.dim() - 1))
    return x[0::2] * lam[0::2] + x[1::2] * lam[1::2]


class BiGRU(nn.Module):
    """Bidirectional GRU over the padded sequence, outputs concatenated.

    Like the JAX module it runs without packing: the backward direction
    reads the flipped padded input, so padded frames enter its recurrence
    first (``nn.GRU`` over packed sequences would give another result for
    every clip shorter than its bucket).  ``dtype`` is the operand type
    of the input projection and the recurrent product and of the carry;
    gates and outputs are f32 (``layers.py:452-459``, ``:528-538``).

    ``kernel`` takes the place of the JAX package's ``TTG_PALLAS_GRU``: the
    recurrence runs through ``ops/kernels/gru.py`` (on the card, the
    hand-written kernels; f32 with its backward kernel, bf16 forward only)
    instead of the grouped loop, in which both directions step together
    (one grouped recurrent product per step).  ``None`` follows the JAX
    default: the kernel for f32 (training), the loop for bf16 (serving).
    The input projection stays one ``torch.matmul`` either way.

    ``bwd`` takes the place of ``TTG_GRU_BWD`` on the f32 kernel path:
    ``None`` (the JAX ``"v1"``) is the f32 recurrence
    (``bigru_pallas_trainable``),
    ``"bf16"`` the bf16 one (``bigru_pallas_trainable_bf16``: bf16 carry,
    bf16-operand backward), which also rounds the input projection's
    operands to bf16 (``layers.py:485-492``); ``"v2"`` / ``"v3"`` the f32
    recurrence with the hoisted backward (``bigru_pallas_trainable_v2`` /
    ``_v3``: the walk without dWh, which one product takes after it).  As
    in the JAX package, ``bwd`` acts on every f32 call through the kernels,
    so also on the bf16 model's f32 training GRU.  ``forward``'s ``dtype``
    overrides the module's for one call: ``Cnn8Rnn`` in bf16 runs its one
    set of parameters in f32 for training and in bf16 for serving.
    :meth:`route` alone turns the call's dtype, ``kernel`` and ``bwd`` into
    the way the call runs.

    The parameters keep ``nn.GRU``'s names.  The JAX tree has no r/z
    recurrent biases, so ``bias_hh_l0[:2H]`` folds into the input bias
    detached: it gets no gradient, and stays where it was (zero for weights
    from the JAX package) under the optimizer.
    """

    def __init__(self, input_size: int, hidden: int,
                 dtype: torch.dtype = torch.float32,
                 kernel: bool | None = None, bwd: str | None = None):
        super().__init__()
        if bwd not in GRU_BWD:
            raise ValueError(f"bwd must be one of {GRU_BWD}")
        self.hidden = hidden
        self.dtype = dtype
        self.bwd = bwd
        self._kernel = kernel
        for sfx in ("", "_reverse"):
            _gru_params(self, input_size, hidden, sfx)

    def route(self, dtype: torch.dtype | None = None) -> tuple:
        """How a call in ``dtype`` (the module's when None) runs:
        ``(carry type, through the kernels, the products' operand type, the
        hoisted backward or None)``.  The operands are bf16 for the bf16
        trainable recurrence (an f32 call on the kernels with
        ``bwd="bf16"``), else the carry's type; the hoisted backward
        (``"v2"`` / ``"v3"``) is taken by an f32 call on the kernels."""
        dt = self.dtype if dtype is None else dtype
        kernel = dt == torch.float32 if self._kernel is None else self._kernel
        f32_kernel = kernel and dt == torch.float32
        b16 = f32_kernel and self.bwd == "bf16"
        hoisted = self.bwd if f32_kernel and self.bwd in gru.VARIANTS \
            else None
        return dt, kernel, torch.bfloat16 if b16 else dt, hoisted

    def _direction(self, sfx: str) -> tuple:
        h = self.hidden
        b_hh = getattr(self, f"bias_hh_l0{sfx}")
        bi = getattr(self, f"bias_ih_l0{sfx}") + torch.cat(
            [b_hh[:2 * h].detach(), torch.zeros_like(b_hh[2 * h:])])
        return (getattr(self, f"weight_ih_l0{sfx}").t(), bi,
                getattr(self, f"weight_hh_l0{sfx}").t(), b_hh[2 * h:])

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """x ``[B, T, In]`` → ``[B, T, 2H]`` f32; ``dtype`` as the module's
        when None."""
        h = self.hidden
        dt, kernel, pd, hoisted = self.route(dtype)
        (wi0, bi0, wh0, bn0), (wi1, bi1, wh1, bn1) = (
            self._direction(""), self._direction("_reverse"))
        # operands rounded to ``pd``, products accumulated in f32
        wi = torch.stack([wi0, wi1]).to(pd).float()         # [2, In, 3H]
        bi = torch.stack([bi0, bi1])                        # [2, 3H]
        xg = torch.stack([x, torch.flip(x, dims=(1,))]).to(pd).float()
        proj = torch.matmul(xg, wi[:, None]) + bi[:, None, None]
        bsz, tlen = x.shape[0], x.shape[1]
        if kernel:
            wh = torch.stack([wh0, wh1])                    # [2, H, 3H]
            bn = torch.stack([bn0, bn1])                    # [2, H]
            tproj = proj.permute(2, 0, 1, 3).reshape(tlen, 2 * bsz, 3 * h)
            if dt == torch.float32:
                ys = gru.bigru_trainable(tproj, wh, bn, pd, hoisted)
            else:
                design = (gru.route(bsz, h, dt)["forward"]
                          if tproj.is_cuda else "cluster")
                ys = gru.gru_forward(tproj, wh, bn, dt, design)
            ys = ys.reshape(tlen, 2, bsz, h).permute(1, 2, 0, 3)
            return torch.cat([ys[0], torch.flip(ys[1], dims=(1,))], dim=-1)
        wh = torch.stack([wh0, wh1]).to(dt).float()         # [2, H, 3H]
        bn = torch.stack([bn0, bn1])[:, None]               # [2, 1, H]
        hid = torch.zeros(2, bsz, h, dtype=dt, device=x.device)
        ys = []
        for t in range(tlen):
            pp = proj[:, :, t]
            rzn = torch.bmm(hid.float(), wh)
            r = torch.sigmoid(pp[..., :h] + rzn[..., :h])
            z = torch.sigmoid(pp[..., h:2 * h] + rzn[..., h:2 * h])
            n = torch.tanh(pp[..., 2 * h:] + r * (rzn[..., 2 * h:] + bn))
            out = (1 - z) * n + z * hid.float()
            ys.append(out)
            hid = out.to(dt)
        ys = torch.stack(ys, dim=2)                         # [2, B, T, H]
        return torch.cat([ys[0], torch.flip(ys[1], dims=(1,))], dim=-1)


def _gru_params(module: nn.Module, input_size: int, hidden: int,
                suffix: str = "") -> None:
    """One GRU direction's parameters by ``nn.GRU``'s names, with the JAX
    tree's initialisers (``layers.py:336-340``): lecun-normal input
    kernels, an orthogonal ``[H, H]`` recurrent kernel a gate, zero
    biases."""
    h3 = 3 * hidden
    wi = nn.Parameter(torch.empty(h3, input_size))
    wh = nn.Parameter(torch.empty(h3, hidden))
    with torch.no_grad():
        wi.normal_(0.0, input_size ** -0.5)
        for g in range(3):
            nn.init.orthogonal_(wh[g * hidden:(g + 1) * hidden])
    module.register_parameter(f"weight_ih_l0{suffix}", wi)
    module.register_parameter(f"weight_hh_l0{suffix}", wh)
    module.register_parameter(f"bias_ih_l0{suffix}",
                              nn.Parameter(torch.zeros(h3)))
    module.register_parameter(f"bias_hh_l0{suffix}",
                              nn.Parameter(torch.zeros(h3)))


class GRUSeq(nn.Module):
    """One GRU direction over the whole padded sequence (JAX
    ``layers.py:344-412``): the input projections of every step as one
    product, then a plain loop of the recurrent products, f32.  Named and
    folded as one direction of :class:`BiGRU` (``bias_hh_l0[:2H]``, which
    the JAX tree lacks, joins the input bias detached).  No kernel
    computes a single direction: the JAX package runs it as a
    ``lax.scan``."""

    def __init__(self, input_size: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.hidden, self.reverse = hidden, reverse
        _gru_params(self, input_size, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.hidden
        b_hh = self.bias_hh_l0
        bi = self.bias_ih_l0 + torch.cat(
            [b_hh[:2 * h].detach(), torch.zeros_like(b_hh[2 * h:])])
        proj = torch.matmul(x, self.weight_ih_l0.t()) + bi    # [B, T, 3H]
        if self.reverse:
            proj = torch.flip(proj, dims=(1,))
        wh = self.weight_hh_l0.t()
        hid = x.new_zeros(x.shape[0], h)
        ys = []
        for t in range(x.shape[1]):
            p = proj[:, t]
            rzn = hid @ wh
            r = torch.sigmoid(p[:, :h] + rzn[:, :h])
            z = torch.sigmoid(p[:, h:2 * h] + rzn[:, h:2 * h])
            n = torch.tanh(p[:, 2 * h:] + r * (rzn[:, 2 * h:] + b_hh[2 * h:]))
            hid = (1 - z) * n + z * hid
            ys.append(hid)
        ys = torch.stack(ys, dim=1)
        return torch.flip(ys, dims=(1,)) if self.reverse else ys


class GRU(nn.Module):
    """Multi-layer GRU, uni- or bidirectional (JAX ``layers.py:546-560``,
    torch ``nn.GRU``'s shape): layer ``layer{i}`` is a :class:`BiGRU`
    (through the GRU kernels in f32, as JAX's ``BiGRU`` takes
    ``bigru_pallas_trainable``) or a :class:`GRUSeq`.  ``kernel`` and
    ``bwd`` are the bidirectional layers' (``BiGRU``)."""

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 bidirectional: bool = False, kernel: bool | None = None,
                 bwd: str | None = None):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_layers = num_layers
        width = input_size
        for i in range(num_layers):
            setattr(self, f"layer{i}",
                    BiGRU(width, hidden, kernel=kernel, bwd=bwd)
                    if bidirectional else GRUSeq(width, hidden))
            width = hidden * (2 if bidirectional else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return x


class _Direction:
    """One direction of a PyTorch recurrent layer over the padded,
    batch-first sequence: its outputs, over the time-flipped sequence
    and flipped back when ``reverse`` (flax's ``nn.RNN(reverse=True,
    keep_order=True)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reverse:
            return torch.flip(super().forward(torch.flip(x, dims=(1,)))[0],
                              dims=(1,))
        return super().forward(x)[0]


class RNNSeq(_Direction, nn.RNN):
    """One Elman (tanh) RNN direction, biases on both sides (JAX
    ``layers.py:563-594``, ``h' = tanh(W_ih x + b_ih + W_hh h + b_hh)``):
    ``nn.RNN``.  No Pallas kernel computes it."""

    def __init__(self, input_size: int, hidden: int, reverse: bool = False):
        super().__init__(input_size, hidden, batch_first=True)
        self.reverse = reverse


class RNN(nn.Module):
    """Multi-layer Elman RNN (JAX ``layers.py:597-613``): ``fwd{i}`` and,
    when bidirectional, ``bwd{i}`` (``direction``: :class:`RNNSeq`),
    concatenated."""

    direction = RNNSeq

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 bidirectional: bool = False):
        super().__init__()
        self.num_layers, self.bidirectional = num_layers, bidirectional
        width = input_size
        for i in range(num_layers):
            setattr(self, f"fwd{i}", self.direction(width, hidden))
            if bidirectional:
                setattr(self, f"bwd{i}", self.direction(width, hidden,
                                                        reverse=True))
            width = hidden * (2 if bidirectional else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            fwd = getattr(self, f"fwd{i}")(x)
            x = (torch.cat([fwd, getattr(self, f"bwd{i}")(x)], dim=-1)
                 if self.bidirectional else fwd)
        return x


class LSTMSeq(_Direction, nn.LSTM):
    """One LSTM direction: flax's ``OptimizedLSTMCell`` (gates ``i, f, g,
    o``, ``c' = f·c + i·g``, ``h' = o·tanh(c')``, the bias on the hidden
    side only) as ``nn.LSTM``, whose gate order is the same: the input
    kernels stack into ``weight_ih_l0``, the hidden ones and their biases
    into ``weight_hh_l0`` / ``bias_hh_l0``, and ``bias_ih_l0`` stays zero
    (no gradient), as the flax cell has none."""

    def __init__(self, input_size: int, hidden: int, reverse: bool = False):
        super().__init__(input_size, hidden, batch_first=True)
        self.reverse = reverse
        with torch.no_grad():
            self.bias_ih_l0.zero_()
        self.bias_ih_l0.requires_grad_(False)


class LSTM(RNN):
    """Multi-layer LSTM (JAX ``layers.py:616-632``): ``fwd{i}`` / ``bwd{i}``
    (:class:`LSTMSeq`), as :class:`RNN`.  No Pallas kernel computes it."""

    direction = LSTMSeq


class PositionalEncoding(Seeded):
    """Sinusoidal positions added to ``x [B, L, D]``, then dropout in train
    mode (JAX ``layers.py:673-689``, reference models/text_encoder.py:
    128-144), the table for ``max_len`` positions in f32 as jnp makes
    it.  Each call in train mode draws a new mask from the module's
    generator."""

    def __init__(self, dropout: float, max_len: int = 100):
        super().__init__()
        self.p, self.max_len = dropout, max_len

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        pos = torch.arange(self.max_len, dtype=torch.float32,
                           device=x.device)[:, None]
        scale = -(torch.log(torch.tensor(10000.0, device=x.device)) / d)
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                     device=x.device) * scale)
        pe = torch.zeros(self.max_len, d, device=x.device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return self._drop(x + pe[None, :x.shape[1]], self.p)
