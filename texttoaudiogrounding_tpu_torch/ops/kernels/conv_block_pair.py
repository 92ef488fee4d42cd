"""Fused PANNs block 2 (64 → C → C, 2×2 pool): ``csrc/conv_block_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block_pair.py:211
fused_block2_pair``.  The TPU kernel's mel-pair lane packing and parity
split serve the TPU's matrix unit; the port computes the same function on
the plain ``[B, T, M, C]`` layout.  Its int8 contract
(``conv_block_pair.py:122-177``) differs from blocks 3-4 in the input
scale: one per (clip, chunk of ``tc`` output times), taken over the
chunk's zero-padded input window — the flat mel-pair rows
``[t0 mp - 2 mp - 1, (t0 + tc + 2) mp + 1)`` of the ``[T mp, 128]`` view
(mp = M / 2) — so each chunk recomputes its conv1 halo rows from its own
quantized input.  The y1 scale is per (clip, chunk) over conv1 rows at
times ``[t0 - 1, t0 + tc + 1)``, out-of-clip rows zeroed.

:func:`fused_block2_pair` launches the kernel for a CUDA tensor and runs
the plain version (:func:`block2_plain`) for a CPU tensor.  The kernel is
the second design, the wgmma implicit GEMM of ``csrc/conv_igemm_sm90.cuh``
(``ttg_conv_block_pair_v2``); the first design (``csrc/conv_block_pair.cu``)
gives the same int8 result bit for bit and runs through :func:`_launch_v1`,
which ``chip_smoke.py`` times beside it, and at the mel counts the second
design does not take (``conv_block.v2_takes``: M outside 8 / 16 / 32 / 64),
counted in ``launches_v1``.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.ops.kernels import _build
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
    check_block_args,
    check_device,
    check_v2_pool,
    double_conv_plain,
    fold_bn,
    kernel_weights,
    scratch,
    scratch_v2,
    v2_takes,
    window_scale,
)

__all__ = ["fused_block2_pair", "block2_plain", "fold_bn"]

launches = 0          # kernel launches through fused_block2_pair
launches_v1 = 0       # the first design's, through _launch_v1


def _pair_vmem_bytes(t: int, mp: int, tc: int, cout: int,
                     quantize: bool, compute_dtype) -> int:
    itb = compute_dtype.itemsize
    wb = 1 if quantize else itb
    rows1 = (tc + 2) * mp
    rows_x = (tc + 4) * mp + 2
    total = ((t + 4) * mp + 2) * 128 * itb
    total += 2 * t * mp * 128 * itb
    total += (rows_x if not quantize else 8) * 128 * itb
    total += (rows_x if quantize else 8) * 128
    total += 2 * (rows1 + 2) * cout * wb
    total += (12 * 128 * cout + 9 * cout * cout) * wb + 4 * cout * 4
    total += 2 * (tc // 2 * mp) * cout * (2 if quantize else itb)
    return total


def _pick_tc_pair(t: int, mp: int, max_rows: int = 2000,
                  cout: int = 128, quantize: bool = True,
                  compute_dtype=torch.bfloat16,
                  vmem_budget: int = 15 * 2**20) -> int:
    """The JAX package's chunk rule (``conv_block_pair.py:319``): the
    largest even tc dividing t with ``(tc + 2) mp <= max_rows``, a pooled
    block of a multiple of 8 rows and the TPU kernel's VMEM estimate
    within budget."""
    best = 0
    for c in range(2, t + 1, 2):
        if (t % c == 0 and (c + 2) * mp <= max_rows
                and (c // 2 * mp) % 8 == 0
                and _pair_vmem_bytes(t, mp, c, cout, quantize,
                                     compute_dtype) <= vmem_budget):
            best = c
    if best == 0:
        raise ValueError(f"no valid pair-chunk for T={t} mp={mp}")
    return best


def pick_tc_pair(t: int, mp: int, cout: int, quantize: bool) -> int:
    """:func:`_pick_tc_pair`, or, where it raises (odd or prime T, very
    long clips: the JAX package runs the XLA block there), the port's own
    rule: the largest even tc with ``(tc + 2) mp <= 2000``, the last chunk
    ragged.  The port runs its kernel for every shape."""
    try:
        return _pick_tc_pair(t, mp, cout=cout, quantize=quantize)
    except ValueError:
        return max(2, (2000 // mp - 2) // 2 * 2)


def pair_window_scale(xf: torch.Tensor, tc: int, nch: int) -> torch.Tensor:
    """``[B, nch]`` input scales: max |x| over each chunk's window of flat
    mel-pair rows ``[j tc mp - 2 mp - 1, (j tc + tc + 2) mp + 1)``."""
    b, t, m, c = xf.shape
    mp = m // 2
    return window_scale(xf.reshape(b, t, mp, 2 * c), tc, nch, 2 * mp + 1,
                        (tc + 4) * mp + 2)


def block2_plain(x, w1, ab1, w2, ab2, *, quantize: bool, tc: int,
                 compute_dtype=torch.bfloat16,
                 divide: bool = False) -> torch.Tensor:
    """The block-2 kernel's arithmetic in plain PyTorch (``compute_dtype``
    and ``divide`` as in ``double_conv_plain``)."""
    return double_conv_plain(x, w1, ab1, w2, ab2, (2, 2), quantize=quantize,
                             tc=tc, x_scale=pair_window_scale,
                             compute_dtype=compute_dtype, divide=divide)


_P, _I = _build.P, _build.I
_ARGS = [_I, _P, _I, _I, _I, _I, _I,
         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_V2_ARGS = _ARGS[:13] + [_P] * 6


def fused_block2_pair(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                      w2: torch.Tensor, ab2: tuple, *,
                      quantize: bool = False,
                      tc: int | None = None,
                      prepared: tuple | None = None) -> torch.Tensor:
    """Fused (conv3x3 → BN → ReLU) × 2 → avg+max 2×2 pool for Cin = 64.

    x ``[B, T, M, 64]`` bf16 (M even); w1 ``[3, 3, 64, C]``, w2 ``[3, 3,
    C, C]`` HWIO f32; ab from :func:`fold_bn`; ``prepared`` as in
    ``fused_double_conv_pool``.  Returns ``[B, T // 2, M // 2, C]`` bf16.
    Serving only (running BN statistics).
    """
    global launches
    b, t, m, cin = x.shape
    cout = w1.shape[-1]
    if cin != 64 or m % 2:
        raise ValueError("block 2 takes Cin = 64 and an even mel count")
    tc = tc or pick_tc_pair(t, m // 2, cout, quantize)
    check_block_args(x, w1, ab1, w2, ab2, (2, 2), tc)
    if not x.is_cuda:
        return block2_plain(x, w1, ab1, w2, ab2, quantize=quantize, tc=tc)
    wk = prepared or kernel_weights(w1, ab1, w2, ab2, quantize)
    if not v2_takes(m, (2, 2)):
        return _launch_v1(x, wk, quantize, tc)
    out = launch(x, wk, quantize, tc)
    launches += 1
    return out


def launch(x: torch.Tensor, wk: tuple, quantize: bool,
           tc: int) -> torch.Tensor:
    """One launch of ``ttg_conv_block_pair_v2`` on checked arguments; ``wk``
    is ``kernel_weights`` of the block's weights.  The caller counts it."""
    b, t, m, cin = x.shape
    cout = wk[0].shape[0]
    check_device(x, *wk)
    check_v2_pool(m, (2, 2))
    xs, y1, y1q, smax = scratch_v2(b, t, m, cin, cout, tc, quantize,
                                   x.device, per_clip=False)
    out = torch.empty(b, t // 2, m // 2, cout, dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.function("conv_block_v2", "ttg_conv_block_pair_v2",
                         _V2_ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, cout, tc,
             *(v.data_ptr() for v in wk), xs.data_ptr(), y1.data_ptr(),
             y1q.data_ptr(), smax.data_ptr(), out.data_ptr(),
             _build.stream())
    _build.check(err, "ttg_conv_block_pair_v2")
    return out


def _launch_v1(x: torch.Tensor, wk: tuple, quantize: bool,
               tc: int) -> torch.Tensor:
    """:func:`launch_v1`, counted in ``launches_v1``."""
    global launches_v1
    out = launch_v1(x, wk, quantize, tc)
    launches_v1 += 1
    return out


def launch_v1(x: torch.Tensor, wk: tuple, quantize: bool,
              tc: int) -> torch.Tensor:
    """:func:`launch` on the first design (``ttg_conv_block_pair``), for the
    shapes the second does not take; the caller counts it."""
    b, t, m, cin = x.shape
    cout = wk[0].shape[0]
    check_device(x, *wk)
    xs, y1, y1q, sx, sy = scratch(b, t, m, cin, cout, tc, quantize,
                                  x.device)
    out = torch.empty(b, t // 2, m // 2, cout, dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.function("conv_block_pair", "ttg_conv_block_pair", _ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, cout, tc,
             *(v.data_ptr() for v in wk), xs.data_ptr(), y1.data_ptr(),
             y1q.data_ptr(), sx.data_ptr(), sy.data_ptr(), out.data_ptr(),
             _build.stream())
    _build.check(err, "ttg_conv_block_pair")
    return out
