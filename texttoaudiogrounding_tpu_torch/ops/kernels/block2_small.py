"""Pair-dense PANNs block 2 (64 → 128, 2×2 pool) on row 3's second design,
``csrc/conv_block_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block_small.py:291
fused_block2`` (kernel ``_block2_kernel :172``).  The TPU kernel's
designs for conv1, ``conv1="banded"`` (K = 6 Cin dots with half-banded
weights) and ``"windows"`` (each output parity's 128-aligned lane window),
and its dense parity-slice conv2 are layouts for the TPU's matrix unit.
What is left on the plain ``[B, T, M, C]`` layout is the function of
``fused_block2_pair`` (row 3), with two differences, both decided here:

* ``tc`` defaults to 50 when ``T // 2`` is a multiple of 25, else 2
  (``:310-311``), and T may be odd: the last chunk is ragged, conv1 rows
  outside the clip are masked and the floor pool drops an odd trailing
  frame (``:300-313``);
* the int8 weights are *divided* by their per-channel scales, as numpy
  does it (``:75 _quant_rows``), not multiplied by their reciprocals.

The scale windows are row 3's: the input scale per (clip, chunk) over the
staged window ``[t0 mp - 2 mp - 1, (t0 + tc + 2) mp + 1)`` of flat
mel-pair rows (``:194-203``), the y1 scale per chunk over the f32 conv1
rows after the ReLU and the clip mask (``:231-237``).

:func:`fused_block2` launches row 3's kernel (``conv_block_pair.launch``,
the wgmma implicit GEMM) for a CUDA tensor and runs ``block2_plain`` for a
CPU tensor.  At the mel counts the second design does not take
(``conv_block.v2_takes``) it runs row 3's first design
(``conv_block_pair.launch_v1``, ``csrc/conv_block_pair.cu``), counted as
``block2_small_v1``.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block_pair
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
    check_block_args,
    check_device,
    kernel_weights,
    v2_takes,
)

__all__ = ["fused_block2", "default_tc", "prepare"]

# kernel launches through fused_block2: row 3's second design, and its
# first where v2_takes says no
launches = {"block2_small": 0, "block2_small_v1": 0}

CONV1 = ("banded", "windows")


def default_tc(t: int) -> int:
    """``conv_block_small.py:310-311``."""
    return 50 if (t // 2) % 25 == 0 else 2


def prepare(w1, ab1, w2, ab2, quantize: bool) -> tuple:
    """The kernel's weights: ``conv_block.kernel_weights`` with the int8
    weights divided by their scales."""
    return kernel_weights(w1, ab1, w2, ab2, quantize, divide=True)


def fused_block2(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                 w2: torch.Tensor, ab2: tuple, *, quantize: bool = True,
                 tc: int | None = None, compute_dtype=torch.bfloat16,
                 conv1: str = "banded",
                 prepared: tuple | None = None) -> torch.Tensor:
    """Fused PANNs block for Cin = 64 → Cout, pool (2, 2).

    x ``[B, T, M, 64]`` (M even, T any); w HWIO f32, ab from ``fold_bn``;
    ``prepared`` is :func:`prepare` of the same weights.  ``conv1`` is
    checked and otherwise ignored: both TPU layouts compute the same sum,
    and it is accepted for parity with the JAX function.  Returns ``[B,
    T // 2, M // 2, Cout]``, bf16 for int8, else ``compute_dtype``.
    Serving only (running BN statistics).
    """
    if conv1 not in CONV1:
        raise ValueError(f"conv1 must be one of {CONV1}")
    t, m, cin = x.shape[1:]
    if cin != 64 or m % 2:
        raise ValueError("block 2 takes Cin = 64 and an even mel count")
    tc = tc or default_tc(t)
    if tc % 2:
        raise ValueError(f"tc={tc} must be even")
    if not x.is_cuda:
        check_device(x, w1, w2, *ab1, *ab2)
        return conv_block_pair.block2_plain(
            x, w1, ab1, w2, ab2, quantize=quantize, tc=tc,
            compute_dtype=compute_dtype, divide=True)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the kernel computes in bf16 (or int8)")
    check_block_args(x, w1, ab1, w2, ab2, (2, 2), tc)
    wk = prepared or prepare(w1, ab1, w2, ab2, quantize)
    if not v2_takes(m, (2, 2)):
        launches["block2_small_v1"] += 1
        return conv_block_pair.launch_v1(x, wk, quantize, tc)
    launches["block2_small"] += 1
    return conv_block_pair.launch(x, wk, quantize, tc)
