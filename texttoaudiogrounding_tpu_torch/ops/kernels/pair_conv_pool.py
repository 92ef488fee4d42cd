"""Pair-packed PANNs block for Cout < 256: ``csrc/pair_conv_pool_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block.py:691
fused_pair_conv_pool`` (kernel ``_pair_kernel :619``, staging
``_pair4_build :578``): (conv3x3 → BN → ReLU) × 2 → avg+max pool with
pool (pt, 2), pt ∈ {1, 2}, over chunks of ``tc`` output times.  The TPU
kernel packs mel pairs on the lane axis and runs each conv as three
banded K = 6 Cin dots; the port computes the same function on the plain
``[B, T, M, C]`` layout.  Two modes:

* full block (``w1`` given): Cin → Cout;
* ``w1=None``: conv1 is skipped, x is the conv1 activation; under
  ``quantize`` it is int8 and ``x_scale`` (one number) is folded into
  conv2's affine.

int8 contract (``:578-616``, ``:658-676``):

* the input scale is per (clip, chunk), ``max|x| / 127`` over the whole
  staged window, ``rows_x + 2`` flat mel-pair rows of the time-padded
  input: ``[t0 mp - 2 mp - 1, (t0 + tc + 2) mp + 1)`` (mp = M / 2), the
  same window as block 2's (``conv_block_pair.py``);
* conv1 rows are times ``[t0 - 1, t0 + tc + 1)``, zeroed outside the
  clip, and stored in ``compute_dtype`` (bf16) before their per-chunk
  scale is taken and they are requantized (``fused_block1``, row 7,
  requantizes f32 rows instead);
* weights are int8 per output channel (the banded matrix's column scales
  are the same per channel), multiplied by the scales' reciprocals, and
  folded into the BN affines; the output is bf16.

T must divide into chunks (``:741-749``); the caller pads.

:func:`fused_pair_conv_pool` launches the kernel for a CUDA tensor and
runs :func:`pair_conv_pool_plain` for a CPU tensor.  The kernel is the
second design, on the wgmma implicit GEMM of ``csrc/conv_igemm_sm90.cuh``
(the full block as row 3's pipeline with conv1 rows stored in bf16; conv2
alone reading the caller's unpadded clip through zero-filling copies).
The first design (``csrc/pair_conv_pool.cu``, WMMA tiles on
one-block-per-group gathers) gives the same int8 result bit for bit; it
runs through :func:`_fused_pair_conv_pool_v1`, which ``chip_smoke.py``
times beside it, and at the mel counts the second design does not take
(``conv_block.v2_takes``: time pairs at M outside 8 / 16 / 32 / 64),
counted under its ``_v1`` keys.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.ops.kernels import _build
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
    _conv_valid_time,
    _windows,
    check_device,
    conv_weights,
    double_conv_plain,
    dual_pool,
    kernel_weights,
    quant_weight,
    scratch,
    scratch_v2,
    v2_takes,
)
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block_pair import (
    pair_window_scale,
)

__all__ = ["fused_pair_conv_pool", "pair_conv_pool_plain", "pick_tc"]

# kernel launches through fused_pair_conv_pool (second design): the full
# block, and conv2 alone (w1=None); of the first design, through
# _fused_pair_conv_pool_v1 or where v2_takes says no
launches = {"pair_conv_pool": 0, "pair_conv_pool_conv2": 0,
            "pair_conv_pool_v1": 0, "pair_conv_pool_conv2_v1": 0}


def pick_tc(t: int, mp: int, pt: int) -> int:
    """The JAX package's chunk rule (``conv_block.py:741-749``): the
    largest multiple of pt dividing t with ``tc mp <= 2000`` and a pooled
    block of a multiple of 8 rows."""
    best = 0
    for c in range(pt, t + 1, pt):
        if t % c == 0 and c * mp <= 2000 and ((c // pt) * mp) % 8 == 0:
            best = c
    if best == 0:
        raise ValueError(f"no valid pair chunk for T={t} M={2 * mp}: pad T")
    return best


def _x_scale(x_scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(1.0 if x_scale is None else x_scale,
                           dtype=torch.float32, device=like.device)


def pair_conv_pool_plain(x, w1, ab1, w2, ab2, pool=(2, 2), *,
                         quantize: bool, tc: int, x_scale=None,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The pair kernel's arithmetic in plain PyTorch.  x ``[B, T, M,
    Cin]`` (int8 for ``w1=None`` under ``quantize``, else any float type,
    taken in ``compute_dtype``); returns ``[B, T // pt, M // 2, Cout]``,
    bf16 for int8, else ``compute_dtype``."""
    if w1 is not None:
        return double_conv_plain(x, w1, ab1, w2, ab2, pool,
                                 quantize=quantize, tc=tc,
                                 x_scale=pair_window_scale,
                                 compute_dtype=compute_dtype, round_y1=True)
    b, t, m, _ = x.shape
    a2, b2 = (v.float() for v in ab2)
    xw = _windows(x, t, 1, 1)                  # zero time padding
    if quantize:
        w2q, s2 = quant_weight(w2.float())
        acc = _conv_valid_time(xw, w2q, torch.float64).float()
        y2 = torch.relu(acc * ((a2 * s2) * _x_scale(x_scale, x)) + b2)
        out_dtype = torch.bfloat16
    else:
        acc = _conv_valid_time(xw.to(compute_dtype), w2.to(compute_dtype),
                               torch.float32)
        y2 = torch.relu(acc * a2 + b2)
        out_dtype = compute_dtype
    return dual_pool(y2, pool[0], 2).to(out_dtype)


def check_args(x, w1, w2, pool, tc, quantize, compute_dtype) -> None:
    b, t, m, cin = x.shape
    pt, pm = pool
    if pm != 2 or pt not in (1, 2) or m % 2:
        raise ValueError(f"the pair kernel pools mel pairs: pool {pool}, "
                         f"M={m}")
    if tc < pt or tc % pt or t % tc:
        raise ValueError(f"T={t} must split into chunks of tc={tc}, a "
                         f"multiple of {pt}: pad T")
    cout = w2.shape[-1]
    c1 = cin if w1 is None else cout
    if tuple(w2.shape) != (3, 3, c1, cout) or (
            w1 is not None and tuple(w1.shape) != (3, 3, cin, cout)):
        raise ValueError("weights must be HWIO [3, 3, Cin, Cout]")
    int8_in = w1 is None and quantize
    if int8_in != (x.dtype == torch.int8):
        raise ValueError("x is int8 exactly when conv1 is skipped under "
                         "quantize")
    if x.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise ValueError("the kernel computes in bf16 (or int8)")
        if not int8_in and x.dtype != torch.bfloat16:
            raise ValueError("x must be bf16")
        if cin % 64 or cout % 64 or not x.is_contiguous():
            raise ValueError("the kernel takes a contiguous x and Cin, Cout "
                             "multiples of 64")


_P, _I = _build.P, _build.I
_ARGS = [_I, _I, _P, _I, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_V2_ARGS = _ARGS[:-3] + [_P, _P]


def prepare(w1, ab1, w2, ab2, quantize: bool, x_scale=None) -> tuple:
    """The kernel's weights (``conv_block.kernel_weights``); for
    ``w1=None`` conv2's twice (the conv1 slots are not read), with
    ``x_scale`` folded into alpha2 under ``quantize``."""
    if w1 is not None:
        return kernel_weights(w1, ab1, w2, ab2, quantize)
    w2k, a2, b2 = conv_weights(w2, ab2, quantize)
    if quantize:
        a2 = (a2 * _x_scale(x_scale, a2)).contiguous()
    return (w2k, a2, b2) * 2


def fused_pair_conv_pool(x: torch.Tensor, w1, ab1, w2: torch.Tensor,
                         ab2: tuple, pool: tuple = (2, 2), *,
                         quantize: bool = False, tc: int | None = None,
                         x_scale=None, compute_dtype=torch.bfloat16,
                         prepared: tuple | None = None) -> torch.Tensor:
    """Pair-packed fused PANNs block for Cout < 256 (pool (pt, 2)).

    x ``[B, T, M, Cin]``; w HWIO f32, ab from ``fold_bn``; ``w1=None``
    (``ab1`` ignored) skips conv1, x then being the conv1 activation (int8
    with the one scale ``x_scale`` under ``quantize``).  T must divide
    into chunks of ``tc`` (by default the JAX package's choice); pad it
    with zero rows beforehand.  ``prepared`` is :func:`prepare` of the
    same weights.  Returns ``[B, T // pt, M // 2, Cout]``.  On the card,
    time pairs at M other than 8, 16, 32 or 64 (which the GEMM cannot pool
    in-thread) run the first design.  Serving only (running BN
    statistics).
    """
    b, t, m, cin = x.shape
    cout = w2.shape[-1]
    tc = tc or pick_tc(t, m // 2, pool[0])
    check_args(x, w1, w2, pool, tc, quantize, compute_dtype)
    check_device(x, w2, *ab2, *(() if w1 is None else (w1, *ab1)))
    if not x.is_cuda:
        return pair_conv_pool_plain(x, w1, ab1, w2, ab2, pool,
                                    quantize=quantize, tc=tc,
                                    x_scale=x_scale,
                                    compute_dtype=compute_dtype)
    wk = prepared or prepare(w1, ab1, w2, ab2, quantize, x_scale)
    check_device(x, *wk)
    if not v2_takes(m, pool):
        return _launch_v1(x, w1 is None, wk, quantize, tc, pool)
    skip = w1 is None
    if skip:                                   # no scratch
        xs = y1 = y1q = smax = x
    else:
        xs, y1, y1q, smax = scratch_v2(b, t, m, cin, cout, tc, quantize,
                                       x.device, per_clip=False,
                                       y1_half=quantize)
    out = torch.empty(b, t // pool[0], m // 2, cout, dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.function("pair_conv_pool_v2", "ttg_pair_conv_pool_v2",
                         _V2_ARGS)
    err = fn(int(quantize), int(skip), x.data_ptr(), b, t, m, cin, cout, tc,
             pool[0], *(v.data_ptr() for v in wk), xs.data_ptr(),
             y1.data_ptr(), y1q.data_ptr(), smax.data_ptr(), out.data_ptr(),
             _build.stream())
    launches["pair_conv_pool_conv2" if skip else "pair_conv_pool"] += 1
    _build.check(err, "ttg_pair_conv_pool_v2")
    return out


def _fused_pair_conv_pool_v1(x: torch.Tensor, w1, ab1, w2: torch.Tensor,
                             ab2: tuple, pool: tuple = (2, 2), *,
                             quantize: bool = False, tc: int | None = None,
                             x_scale=None,
                             prepared: tuple | None = None) -> torch.Tensor:
    """The first design (``csrc/pair_conv_pool.cu``) on a CUDA tensor,
    arguments as :func:`fused_pair_conv_pool`; nothing served calls it.
    ``chip_smoke.py`` holds the second design to it."""
    b, t, m, cin = x.shape
    cout = w2.shape[-1]
    tc = tc or pick_tc(t, m // 2, pool[0])
    check_args(x, w1, w2, pool, tc, quantize, torch.bfloat16)
    if not x.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    check_device(x, w2, *ab2, *(() if w1 is None else (w1, *ab1)))
    wk = prepared or prepare(w1, ab1, w2, ab2, quantize, x_scale)
    check_device(x, *wk)
    return _launch_v1(x, w1 is None, wk, quantize, tc, pool)


def _launch_v1(x, skip: bool, wk: tuple, quantize: bool, tc: int,
               pool) -> torch.Tensor:
    """The first design on checked arguments, counted under its ``_v1``
    keys."""
    b, t, m, cin = x.shape
    cout = wk[0].shape[0]
    if skip:                                   # no scratch
        xs = y1 = y1q = sx = sy = x
    else:
        xs, y1, y1q, sx, sy = scratch(b, t, m, cin, cout, tc, quantize,
                                      x.device, y1_half=quantize)
    out = torch.empty(b, t // pool[0], m // 2, cout, dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.function("pair_conv_pool", "ttg_pair_conv_pool", _ARGS)
    err = fn(int(quantize), int(skip), x.data_ptr(), b, t, m, cin, cout, tc,
             pool[0], *(v.data_ptr() for v in wk), xs.data_ptr(),
             y1.data_ptr(), y1q.data_ptr(), sx.data_ptr(), sy.data_ptr(),
             out.data_ptr(), _build.stream())
    launches["pair_conv_pool_conv2_v1" if skip else "pair_conv_pool_v1"] += 1
    _build.check(err, "ttg_pair_conv_pool")
    return out
