"""Shared building blocks: the PANNs ConvBlock, the CDur block with its LP
pool, the grouped-scan BiGRU, SpecAugment and mixup.

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

import torch
import torch.nn as nn
import torch.nn.functional as F

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

CONV_MODES = (None, "bf16", "int8")
# block 1's modes under conv_mode="int8" (the JAX TTG_B1_QUANT: "mixed" or
# "conv1", "1", "0") → fused_block1_pair's quantize
BLOCK1_QUANT = {"conv1": "conv1", "int8": True, "bf16": False}
GRU_BWD = (None, "bf16", "v2", "v3")


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm1d | nn.BatchNorm2d
                    ) -> torch.Tensor:
    """Running-statistics BN over the last axis, in flax's arithmetic:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x - bn.running_mean) * mul + bn.bias


def update_running(bn: nn.BatchNorm1d | nn.BatchNorm2d, mean: torch.Tensor,
                   var: torch.Tensor) -> None:
    """flax's running-statistics rule: ``0.9 · running + 0.1 · batch``."""
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
    ``_normalize`` promotes ``x - mean``; the caller casts it."""
    dims = tuple(range(x.dim() - 1))
    xf = x.float()
    mean = xf.mean(dim=dims)
    var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
    update_running(bn, mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean) * mul + bn.bias


class ConvBlock(nn.Module):
    """PANNs double-conv block: (conv3x3 → BN → ReLU) × 2 → avg+max pool.

    ``conv_mode=None`` is the plain f32 path (the reference);
    ``"bf16"`` / ``"int8"`` route the block through the hand-written
    kernels with the BN folded into their epilogues, as the JAX serving
    path routes it under ``TTG_FUSED_CONV``:

    * Cin = 1, 64 mels, pool (2, 2) → block 1 (``fused_block1_pair``;
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
                 wino: bool = False):
        super().__init__()
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
               bn_train: bool | None = None) -> torch.Tensor:
        if bn_train is None:
            bn_train = self.training
        norm = batch_norm_train if bn_train else batch_norm_eval
        dt = x.dtype
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt),
                         padding=1).permute(0, 2, 3, 1)
            if bn is self.bn2 and self._pool_kernel_ok(y, pool_size):
                if self.bn_pool and bn_train:
                    out, mean, var = bn_relu_dual_pool(
                        y, bn.weight, bn.bias, pool_size, bn.eps)
                    update_running(bn, mean, var)
                    return out
                if self.pool_vjp:
                    return dual_pool_relu(norm(y, bn).to(dt), pool_size)
            x = torch.relu(norm(y, bn).to(dt))
        mx = F.max_pool2d(x.permute(0, 3, 1, 2), pool_size)
        if dt == torch.float32:
            avg = F.avg_pool2d(x.permute(0, 3, 1, 2), pool_size)
            return (avg + mx).permute(0, 2, 3, 1)
        # flax's avg_pool in bf16 is XLA's reduce_window: the window sum
        # rounds after every add, in window order (F.avg_pool2d would sum
        # in f32 and round once)
        kt, km = pool_size
        b, t, m, c = x.shape
        v = x[:, :t // kt * kt, :m // km * km].reshape(
            b, t // kt, kt, m // km, km, c)
        s = v[:, :, 0, :, 0]
        for k in range(1, kt * km):
            s = s + v[:, :, k // km, :, k % km]
        return s / (kt * km) + mx.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, pool_size=(2, 2),
                bn_train: bool | None = None) -> torch.Tensor:
        """x ``[B, T, M, Cin]`` → ``[B, T // pt, M // pm, Cout]``.  In
        train mode the block runs the plain path (the JAX package runs its
        train-mode convolutions in XLA), through the pool kernels where
        they are opted in, with batch statistics unless ``bn_train`` is
        False (``Cnn8Rnn(freeze_bn=True)``: the running statistics, and no
        ``bn_pool``, whose kernel computes the batch statistics; JAX routes
        it on ``bn_train``, ``layers.py:94-100``).  None follows the mode."""
        if self.training and self.conv_mode is not None:
            raise ValueError("train mode runs the plain path: conv_mode=None")
        if self.conv_mode is None:
            return self._plain(x, tuple(pool_size), bn_train)
        quantize = self.conv_mode == "int8"
        x = x.to(torch.bfloat16).contiguous()
        cin, cout = x.shape[3], self.conv1.out_channels
        pool = tuple(pool_size)
        if cin == 1 and cout == 64 and x.shape[2] == 64 and pool == (2, 2):
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
    in ``x``'s dtype; halves the batch (JAX ``layers.py:663-670``)."""
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
        # the JAX tree's initialisers (layers.py:336-340): lecun-normal
        # input kernels, an orthogonal [H, H] recurrent kernel per gate,
        # zero biases
        with torch.no_grad():
            for sfx in ("", "_reverse"):
                getattr(self, f"weight_ih_l0{sfx}").normal_(
                    0.0, input_size ** -0.5)
                wh = getattr(self, f"weight_hh_l0{sfx}")
                for g in range(3):
                    nn.init.orthogonal_(wh[g * hidden:(g + 1) * hidden])

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
