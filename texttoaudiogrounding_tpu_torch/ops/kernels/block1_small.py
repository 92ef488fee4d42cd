"""PANNs block 1 from the log-mel: ``csrc/block1_small_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block_small.py:471
fused_block1`` (kernel ``_block1_kernel :420``): Cin = 1 → 64 → 64, pool
(2, 2), from the bn0 output.  The TPU kernel folds conv1 in as one K = 16
bf16 dot over an im2col staged outside it (``:401 conv1_im2col``: row
(t, mel pair j) holds the 12 taps feeding both parities, mels 2j - 1 ..
2j + 2 at times t - 1 .. t + 1, and 4 zero lanes), and runs conv2 as
banded K = 384 int8 dots; the port keeps the arithmetic, not the layout:

* conv1: bf16 operands, f32 sums (the products are exact in f32; the
  port adds them in tap order), BN, ReLU, rows outside the clip zeroed;
* int8 (the default): y1 is requantized per chunk of ``tc`` output
  frames with ``max(y1) / 127`` over the chunk's f32 rows, times
  ``[t0 - 1, t0 + tc + 1)`` — not rounded to bf16 first, unlike
  ``fused_pair_conv_pool`` (``:438-444``); w2 int8 per output channel,
  *divided* by its scales in numpy (``:75 _quant_rows``), the scales
  folded into the BN affine; int32 sums;
* f32 avg+max pool, the output bf16 (int8) or ``compute_dtype``;
* ``tc`` defaults to 48 when padding T to a multiple of 48 adds at most
  96 frames (``:488-489``), else 2; T is padded to the chunk grid;
* any even mel count M (``:484-486``, ``mp = m // 2``; the docstring's
  "M = 64" is Cnn8Rnn's), the output ``[B, T // 2, M // 2, 64]``.

:func:`fused_block1` launches the second design for a CUDA tensor and runs
:func:`block1_small_plain` for a CPU tensor.  The second design computes
conv1 from the log-mel itself, without the im2col (in int8 twice: a max
pass, then the rows quantized into conv2's mel-padded input), and conv2
on the wgmma implicit GEMM of ``csrc/conv_igemm_sm90.cuh``, which pools
time pairs inside a thread and so takes M 8, 16, 32 or 64
(``conv_block.v2_takes``).  The first design (``csrc/block1_small.cu``:
conv1 from the im2col built in PyTorch, f32 y1, a requantize pass and WMMA
tiles) gives the same int8 result bit for bit at any even M.
:func:`fused_block1` runs it, counted as ``block1_small_v1``, at the other
even M, as rows 3-6 route those shapes; :func:`_fused_block1_v1` reaches
it at every M, and ``chip_smoke.py`` times it beside the second.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.kernels import _build
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
    _windows,
    check_device,
    conv2_pool_plain,
    conv_weights,
    v2_takes,
)

__all__ = ["fused_block1", "block1_small_plain", "conv1_im2col",
           "default_tc"]

# kernel launches through fused_block1 (second design) and
# _fused_block1_v1 (the first)
launches = {"block1_small": 0, "block1_small_v1": 0}


def default_tc(t: int) -> int:
    """``conv_block_small.py:488-489``."""
    return 48 if -(-t // 48) * 48 <= t + 96 else 2


def conv1_im2col(x_mel: torch.Tensor, t_grid: int) -> torch.Tensor:
    """``[B, T, M]`` → ``[B, t_grid * M / 2, 16]``: row (t, j) holds mels
    2j - 1 + dm4 (dm4 < 4) at times t - 1 + dt (dt < 3), column dt * 4 +
    dm4, zero outside the clip, then 4 zero columns
    (``conv_block_small.py:401``)."""
    b, t, m = x_mel.shape
    mp = m // 2
    x = F.pad(x_mel, (1, 2, 1, 1 + t_grid - t))
    cols = [x[:, dt:dt + t_grid, dm4:dm4 + 2 * mp:2]
            for dt in range(3) for dm4 in range(4)]
    stacked = F.pad(torch.stack(cols, dim=-1), (0, 4))
    return stacked.reshape(b, t_grid * mp, 16)


def _conv1(xim: torch.Tensor, w1: torch.Tensor, t_grid: int) -> torch.Tensor:
    """conv1 sums ``[B, t_grid, M, C]`` f32 from the im2col: output mel
    2j + p takes column dt * 4 + dm + p with weight w1[dt, dm], the
    products added in tap order dt * 3 + dm."""
    b = xim.shape[0]
    mp = xim.shape[1] // t_grid
    x = xim.reshape(b, t_grid, mp, 16).float()
    w = w1[:, :, 0, :].reshape(9, -1).float()
    parts = []
    for p in range(2):
        acc = None
        for k in range(9):
            term = x[..., (k // 3) * 4 + k % 3 + p, None] * w[k]
            acc = term if acc is None else acc + term
        parts.append(acc)
    return torch.stack(parts, dim=3).reshape(b, t_grid, 2 * mp, -1)


def block1_small_plain(x_mel, w1, ab1, w2, ab2, *, quantize: bool, tc: int,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The block's arithmetic in plain PyTorch."""
    b, t, _ = x_mel.shape
    nch = -(-t // tc)
    t_grid = nch * tc
    xim = conv1_im2col(x_mel.to(compute_dtype), t_grid)
    acc = _windows(_conv1(xim, w1.to(compute_dtype), t_grid), tc, 1, nch)
    a1, b1 = (v.float() for v in ab1)
    time = (torch.arange(nch, device=x_mel.device)[:, None] * tc - 1
            + torch.arange(tc + 2, device=x_mel.device)[None])
    valid = ((time >= 0) & (time < t)).repeat(b, 1)[:, :, None, None]
    y1 = torch.where(valid, torch.relu(acc * a1 + b1), 0.0)
    return conv2_pool_plain(y1, w2, ab2, (2, 2), b, t, quantize=quantize,
                            compute_dtype=compute_dtype, divide=True)


_P, _I = _build.P, _build.I
_ARGS = [_I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _P]


def prepare(w1, ab1, w2, ab2, quantize: bool) -> tuple:
    """(w1 [9, 64] bf16, alpha1, beta1, w2 [64, 576], alpha2, beta2): w2
    int8 divided by its per-channel scales, folded into alpha2, or bf16."""
    w1k = w1[:, :, 0, :].reshape(9, -1).to(torch.bfloat16).contiguous()
    a1, b1 = (v.float().contiguous() for v in ab1)
    return (w1k, a1, b1) + conv_weights(w2, ab2, quantize, divide=True)


def _check_args(x_mel, w1, w2, tc: int | None) -> int:
    """The block's shapes; returns the chunk."""
    if x_mel.dim() != 3 or x_mel.shape[2] < 2 or x_mel.shape[2] % 2:
        raise ValueError(f"x_mel must be [B, T, M] with M even (the mel "
                         f"pairs of conv_block_small.py:486), got "
                         f"{tuple(x_mel.shape)}")
    if tuple(w1.shape) != (3, 3, 1, 64) or tuple(w2.shape) != (3, 3, 64, 64):
        raise ValueError("block 1 takes w1 [3, 3, 1, 64], w2 [3, 3, 64, 64]")
    tc = tc or default_tc(x_mel.shape[1])
    if tc % 2:
        raise ValueError(f"tc={tc} must be even")
    return tc


_V2_ARGS = [_I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _P]


def fused_block1(x_mel: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                 w2: torch.Tensor, ab2: tuple, *, quantize: bool = True,
                 tc: int | None = None, compute_dtype=torch.bfloat16,
                 prepared: tuple | None = None) -> torch.Tensor:
    """Fused PANNs block 1 (1 → 64 → 64, pool (2, 2)) from the log-mel.

    x_mel ``[B, T, M]``, M even (the bn0 output); w1 ``[3, 3, 1, 64]``,
    w2 ``[3, 3, 64, 64]`` HWIO f32; ab from ``fold_bn``; ``prepared`` is
    :func:`prepare` of the same weights.  Returns ``[B, T // 2, M // 2,
    64]``, bf16 for int8, else ``compute_dtype``.  On a CUDA tensor M 8,
    16, 32 and 64 run the second design and the other even M the first
    (counted as ``block1_small_v1``).  Serving only (running BN
    statistics).
    """
    b, t, m = x_mel.shape
    tc = _check_args(x_mel, w1, w2, tc)
    check_device(x_mel, w1, w2, *ab1, *ab2)
    if not x_mel.is_cuda:
        return block1_small_plain(x_mel, w1, ab1, w2, ab2,
                                  quantize=quantize, tc=tc,
                                  compute_dtype=compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the kernel computes in bf16 (or int8)")
    if not v2_takes(m, (2, 2)):
        return _launch_v1(x_mel, w1, ab1, w2, ab2, quantize, tc, prepared)
    x = x_mel.to(torch.bfloat16).contiguous()
    wk = prepared or prepare(w1, ab1, w2, ab2, quantize)
    check_device(x_mel, *wk)
    g = b * -(-t // tc)
    y1 = torch.empty(g, tc + 2, m + 2, 64, device=x.device,
                     dtype=torch.int8 if quantize else torch.bfloat16)
    ymax = torch.empty(g if quantize else 1, dtype=torch.int32,
                       device=x.device)
    out = torch.empty(b, t // 2, m // 2, 64, dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.function("block1_small_v2", "ttg_block1_small_v2", _V2_ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, tc,
             *(v.data_ptr() for v in wk), ymax.data_ptr(), y1.data_ptr(),
             out.data_ptr(), _build.stream())
    launches["block1_small"] += 1
    _build.check(err, "ttg_block1_small_v2")
    return out


def _fused_block1_v1(x_mel: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                     w2: torch.Tensor, ab2: tuple, *, quantize: bool = True,
                     tc: int | None = None,
                     prepared: tuple | None = None) -> torch.Tensor:
    """The first design (``csrc/block1_small.cu``, from the im2col) on a
    CUDA tensor, arguments as :func:`fused_block1`; nothing served calls
    it at M 8, 16, 32 or 64.  ``chip_smoke.py`` holds the second design to
    it."""
    tc = _check_args(x_mel, w1, w2, tc)
    if not x_mel.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    check_device(x_mel, w1, w2, *ab1, *ab2)
    return _launch_v1(x_mel, w1, ab1, w2, ab2, quantize, tc, prepared)


def _launch_v1(x_mel, w1, ab1, w2, ab2, quantize: bool, tc: int,
               prepared: tuple | None) -> torch.Tensor:
    """The first design on checked arguments, counted in
    ``launches["block1_small_v1"]``."""
    b, t, m = x_mel.shape
    nch = -(-t // tc)
    xim = conv1_im2col(x_mel.to(torch.bfloat16), nch * tc).contiguous()
    wk = prepared or prepare(w1, ab1, w2, ab2, quantize)
    check_device(x_mel, *wk)
    dev = x_mel.device
    y1 = torch.empty(b * nch, tc + 2, m, 64, device=dev,
                     dtype=torch.float32 if quantize else torch.bfloat16)
    y1q = torch.empty_like(y1, dtype=torch.int8) if quantize else y1
    sy = torch.empty(b * nch, device=dev)
    out = torch.empty(b, t // 2, m // 2, 64, dtype=torch.bfloat16,
                      device=dev)
    fn = _build.function("block1_small", "ttg_block1_small", _ARGS)
    err = fn(int(quantize), xim.data_ptr(), b, t, m, tc,
             *(v.data_ptr() for v in wk), y1.data_ptr(), y1q.data_ptr(),
             sy.data_ptr(), out.data_ptr(), _build.stream())
    launches["block1_small_v1"] += 1
    _build.check(err, "ttg_block1_small")
    return out
