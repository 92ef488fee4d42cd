"""Shared building blocks: the PANNs ConvBlock and the grouped-scan BiGRU.

Ports of ``texttoaudiogrounding_tpu/models/layers.py:58-292`` (ConvBlock)
and ``:425-543`` (BiGRU).  Activations are channel-last, ``[B, T, M, C]``,
as in the JAX package; parameters and state-dict names follow the
reference torch modules (``conv1.weight`` is ``[Cout, Cin, 3, 3]``, BN
keeps running statistics, the GRU is named like ``nn.GRU``), which is the
layout ``weights.from_jax_variables`` produces.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair, gru
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

CONV_MODES = (None, "bf16", "int8")


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d
                    ) -> torch.Tensor:
    """Running-statistics BN over the last axis, in flax's arithmetic:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x - bn.running_mean) * mul + bn.bias


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d
                     ) -> torch.Tensor:
    """Batch-statistics BN over the last axis, in flax's arithmetic
    (``layers.py:265``): ``var = mean(x²) - mean(x)²`` (biased, clipped at
    0), and the running statistics move to ``0.9 · running + 0.1 · batch``
    (``nn.BatchNorm2d`` would keep the unbiased variance)."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dim=dims)
    var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
        bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean) * mul + bn.bias


class ConvBlock(nn.Module):
    """PANNs double-conv block: (conv3x3 → BN → ReLU) × 2 → avg+max pool.

    ``conv_mode=None`` is the plain f32 path (the reference);
    ``"bf16"`` / ``"int8"`` route the block through the hand-written
    kernels with the BN folded into their epilogues, as the JAX serving
    path routes it under ``TTG_FUSED_CONV``:

    * Cin = 1, 64 mels, pool (2, 2) → block 1 (``fused_block1_pair``;
      int8 serving runs it in its ``"conv1"`` mode: int8 conv1, bf16 conv2);
    * Cin = 64, Cout a multiple of 128, pool (2, 2) → block 2
      (``fused_block2_pair``);
    * otherwise → ``fused_double_conv_pool`` (blocks 3 and 4).

    The kernels' weights (HWIO, BN folded, quantized and laid out for the
    card) are made once and kept until a parameter or buffer changes.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 conv_mode: str | None = None):
        super().__init__()
        if conv_mode not in CONV_MODES:
            raise ValueError(f"conv_mode must be one of {CONV_MODES}")
        self.conv_mode = conv_mode
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.bn2 = nn.BatchNorm2d(out_channels)
        self._kept = (None, None)

    def _kernel_weights(self, block1: bool, quantize: bool) -> tuple:
        """(w1, ab1, w2, ab2, the kernel's layout or None on the CPU),
        made anew only when a tensor they come from is replaced or
        written in place (``load_state_dict``, ``.to``)."""
        src = (self.conv1.weight, self.conv2.weight) + tuple(
            t for bn in (self.bn1, self.bn2)
            for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var))
        key = (block1, quantize) + tuple(
            (t.data_ptr(), t._version) for t in src)
        if self._kept[0] != key:
            with torch.no_grad():
                w1 = self.conv1.weight.permute(2, 3, 1, 0)   # HWIO
                w2 = self.conv2.weight.permute(2, 3, 1, 0)
                ab1, ab2 = (fold_bn(bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, bn.eps)
                            for bn in (self.bn1, self.bn2))
                prep = None
                if w1.is_cuda and block1:
                    prep = conv_block1_pair.kernel_weights(
                        w1, ab1, w2, ab2, "conv1" if quantize else False)
                elif w1.is_cuda:
                    prep = kernel_weights(w1, ab1, w2, ab2, quantize)
            self._kept = (key, (w1, ab1, w2, ab2, prep))
        return self._kept[1]

    def _plain(self, x: torch.Tensor, pool_size) -> torch.Tensor:
        norm = batch_norm_train if self.training else batch_norm_eval
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, padding=1)
            x = torch.relu(norm(y.permute(0, 2, 3, 1), bn))
        y = x.permute(0, 3, 1, 2)
        y = F.avg_pool2d(y, pool_size) + F.max_pool2d(y, pool_size)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, pool_size=(2, 2)) -> torch.Tensor:
        """x ``[B, T, M, Cin]`` → ``[B, T // pt, M // pm, Cout]``.  In
        train mode the block runs the plain path with batch statistics (the
        JAX package runs its train-mode blocks in XLA, without kernels)."""
        if self.training and self.conv_mode is not None:
            raise ValueError("train mode runs the plain path: conv_mode=None")
        if self.conv_mode is None:
            return self._plain(x, tuple(pool_size))
        quantize = self.conv_mode == "int8"
        x = x.to(torch.bfloat16).contiguous()
        cin, cout = x.shape[3], self.conv1.out_channels
        pool = tuple(pool_size)
        if cin == 1 and cout == 64 and x.shape[2] == 64 and pool == (2, 2):
            *w, prep = self._kernel_weights(True, quantize)
            return fused_block1_pair(
                x[..., 0].contiguous(), *w,
                quantize="conv1" if quantize else False, prepared=prep)
        *w, prep = self._kernel_weights(False, quantize)
        if (cin == 64 and cout % 128 == 0 and pool == (2, 2)
                and x.shape[2] % 2 == 0):
            return fused_block2_pair(x, *w, quantize=quantize, prepared=prep)
        return fused_double_conv_pool(x, *w, pool, quantize=quantize,
                                      prepared=prep)


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

    The parameters keep ``nn.GRU``'s names.  The JAX tree has no r/z
    recurrent biases, so ``bias_hh_l0[:2H]`` folds into the input bias
    detached: it gets no gradient, and stays where it was (zero for weights
    from the JAX package) under the optimizer.
    """

    def __init__(self, input_size: int, hidden: int,
                 dtype: torch.dtype = torch.float32,
                 kernel: bool | None = None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.kernel = dtype == torch.float32 if kernel is None else kernel
        h3 = 3 * hidden
        for sfx in ("", "_reverse"):
            self.register_parameter(
                f"weight_ih_l0{sfx}",
                nn.Parameter(torch.empty(h3, input_size)))
            self.register_parameter(
                f"weight_hh_l0{sfx}", nn.Parameter(torch.empty(h3, hidden)))
            self.register_parameter(
                f"bias_ih_l0{sfx}", nn.Parameter(torch.zeros(h3)))
            self.register_parameter(
                f"bias_hh_l0{sfx}", nn.Parameter(torch.zeros(h3)))

    def _direction(self, sfx: str) -> tuple:
        h = self.hidden
        b_hh = getattr(self, f"bias_hh_l0{sfx}")
        bi = getattr(self, f"bias_ih_l0{sfx}") + torch.cat(
            [b_hh[:2 * h].detach(), torch.zeros_like(b_hh[2 * h:])])
        return (getattr(self, f"weight_ih_l0{sfx}").t(), bi,
                getattr(self, f"weight_hh_l0{sfx}").t(), b_hh[2 * h:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, T, In]`` → ``[B, T, 2H]`` f32."""
        h, dt = self.hidden, self.dtype
        (wi0, bi0, wh0, bn0), (wi1, bi1, wh1, bn1) = (
            self._direction(""), self._direction("_reverse"))
        # operands rounded to ``dtype``, products accumulated in f32
        wi = torch.stack([wi0, wi1]).to(dt).float()         # [2, In, 3H]
        bi = torch.stack([bi0, bi1])                        # [2, 3H]
        xg = torch.stack([x, torch.flip(x, dims=(1,))]).to(dt).float()
        proj = torch.matmul(xg, wi[:, None]) + bi[:, None, None]
        bsz, tlen = x.shape[0], x.shape[1]
        if self.kernel:
            wh = torch.stack([wh0, wh1])                    # [2, H, 3H]
            bn = torch.stack([bn0, bn1])                    # [2, H]
            tproj = proj.permute(2, 0, 1, 3).reshape(tlen, 2 * bsz, 3 * h)
            if dt == torch.float32:
                ys = gru.bigru_trainable(tproj, wh, bn)
            else:
                ys = gru.gru_forward(tproj, wh, bn, dt)
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
