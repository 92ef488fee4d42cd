"""Fused PANNs block 1 (1 → 64 → 64, 2×2 pool): ``csrc/conv_block1_pair.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block1_pair.py:346
fused_block1_pair`` in its three modes: ``quantize="conv1"`` (the serving
default), ``False`` (bf16) and ``True`` (all int8, the JAX package's
``TTG_B1_QUANT=1``).  The TPU kernel's banded conv1 matrix and its packed
output order serve the TPU's matrix unit; the port keeps their
arithmetic, not their layout:

* ``"conv1"`` and ``True``: x is int8 with one scale per clip,
  ``max|x| / 127`` floored at 1e-6, all in bf16 arithmetic as the TPU path
  computes it (``conv_block1_pair.py:432-436``).  w1 is quantized per
  column of the banded matrix (``:77-96``, ``:412-415``), i.e. per
  (output mel, channel): output mels 0 and 63 see only 6 in-band taps,
  and their scale is the max over those.  conv1 sums in int32, then
  ``acc (a1 s_w) s_x + b1``;
* ``"conv1"``: ReLU, y1 in bf16, not requantized; conv2 in bf16 with f32
  accumulation;
* ``True``: y1 is requantized once per time chunk of ``tc`` output frames
  (``:144-171``): the chunk's conv1 rows are times ``[j tc - 1, j tc +
  tc]``, computed from the zero-padded input, and its scale is
  ``max(max(y1), 1e-6) / 127`` over all of them, those outside the clip
  too; the int8 values are ``clip(round(y1 / sy), 0, 127)`` (the lower
  clip is the ReLU), with the rows outside the clip zeroed afterwards
  (conv2's zero padding, ``:181-198``).  w2 is int8 per output channel,
  its scale folded into the BN affine with ``sy``; int32 sums.  So the
  result depends on ``tc`` (the JAX ``TTG_B1_TC``);
* ``False``: conv1 in bf16 with f32 accumulation, conv2 as in
  ``"conv1"``;
* every mode: BN, ReLU, y2 rounded to bf16 and pooled in bf16, time pairs
  first, then mel pairs.

``mode="single"`` (the JAX ``TTG_B1_MODE``, ``:239 _kernel_single``)
stages y1 once per chunk with a two-row halo, times ``[j tc - 2, j tc + tc
+ 1]``.  In ``"conv1"`` and ``False`` that is the same sum as ``"triple"``
and the same launch here.  Under ``True`` the chunk's y1 scale is taken over
those ``tc + 4`` rows (``:260-281``), against ``"triple"``'s ``tc + 2``, so
the int8 result is its own; the out-of-clip rows are zeroed after the scale
as in ``"triple"`` (the TPU kernel leaves row ``t = -2`` as it is, which
feeds only discarded outputs).

:func:`fused_block1_pair` launches the kernel for a CUDA tensor and runs
:func:`block1_plain` for a CPU tensor.  The kernel is the second design,
``csrc/conv_block1_v2.cu``: the clip's x scale as a wide max, then in
``"conv1"`` mode one persistent kernel that computes each tile's y1 halo
with conv1 on the CUDA cores into shared memory and conv2 from there on
``wgmma``; in the other modes conv1 straight into the mel-padded y1 (bf16,
or under ``True`` int8 from a max pass and a recompute, with no f32 y1)
and conv2 on the wgmma implicit GEMM of ``csrc/conv_igemm_sm90.cuh``, both
with block 1's bf16 pool.
The first design (``csrc/conv_block1_pair.cu``) gives the same int8
result bit for bit and is reachable only through
:func:`_fused_block1_pair_v1`, which ``chip_smoke.py`` times beside it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.kernels import _build
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
    _conv_valid_time,
    _quant_i8,
    check_device,
    fold_bn,
    over127,
    quant_weight,
)

__all__ = ["fused_block1_pair", "block1_plain", "fold_bn"]

# kernel launches through fused_block1_pair: "conv1" and False modes (either
# staging), and the all-int8 mode in "triple" and in "single" staging; and
# the first design's, in any mode, through _fused_block1_pair_v1
launches = {"conv_block1_pair": 0, "conv_block1_pair_int8": 0,
            "conv_block1_pair_single": 0, "conv_block1_pair_v1": 0}
# the y1 rows each side of a chunk, by staging (mode)
HALO = {"triple": 1, "single": 2}

_M = 64


def conv1_weights(w1: torch.Tensor) -> tuple:
    """Banded-column int8 quantization of w1 ``[3, 3, 1, C]``:
    ``(wq [64 mel, 9 taps, C] int8, scales [64 mel, C])``; a tap whose
    input mel falls outside the axis is zero."""
    w = w1[:, :, 0, :].float()                      # [dt, dm, C]
    c = w.shape[-1]
    absw = w.abs()
    s = absw.amax(dim=(0, 1))[None].repeat(_M, 1)
    s[0] = absw[:, 1:].amax(dim=(0, 1))             # mel -1 is padding
    s[_M - 1] = absw[:, :2].amax(dim=(0, 1))        # mel 64 is padding
    s = over127(torch.clamp(s, min=1e-8))
    inv = 1.0 / s                                   # [64, C]
    wq = _quant_i8(w.reshape(9, c)[None], inv[:, None])   # [64, 9, C]
    band = torch.ones(_M, 3, 3, 1, dtype=torch.int8, device=w.device)
    band[0, :, 0] = 0
    band[_M - 1, :, 2] = 0
    return (wq * band.reshape(_M, 9, 1)).contiguous(), s


def clip_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-clip int8 scale of the conv1 input, in bf16 arithmetic."""
    return over127(torch.clamp(x.abs().amax(dim=(1, 2)), min=1e-6))


def _taps(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, 64]`` → ``[B, T, 64, 9]`` zero-padded 3×3 neighbourhoods,
    tap = dt * 3 + dm."""
    xp = F.pad(x, (1, 1, 1, 1))
    p = xp.unfold(1, 3, 1).unfold(2, 3, 1)          # [B, T, 64, 3, 3]
    return p.reshape(*x.shape, 9)


def _pool_bf16(y: torch.Tensor) -> torch.Tensor:
    """avg+max 2×2 pool of ``[B, T, 64, C]`` in y's type (bf16 on the
    serving path), time pairs first."""
    b, t, m, c = y.shape
    v = y[:, :t // 2 * 2].reshape(b, t // 2, 2, m // 2, 2, c)
    s, mx = v[:, :, 0] + v[:, :, 1], torch.maximum(v[:, :, 0], v[:, :, 1])
    s = s[..., 0, :] + s[..., 1, :]
    mx = torch.maximum(mx[..., 0, :], mx[..., 1, :])
    return s * 0.25 + mx


def block1_plain(x, w1, ab1, w2, ab2, *, quantize="conv1",
                 tc: int = 48, mode: str = "triple",
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The block-1 kernel's arithmetic in plain PyTorch.  x ``[B, T, 64]``
    bf16 → ``[B, T // 2, 32, 64]`` bf16; ``tc`` and ``mode`` act only with
    ``quantize=True``.  Without it, ``compute_dtype=torch.float32`` runs
    the JAX kernel's f32 mode (operands, y1 and the pool in f32; the card
    kernel computes in bf16 only)."""
    a1, b1 = (v.float() for v in ab1)
    a2, b2 = (v.float() for v in ab2)
    if quantize in ("conv1", True):
        sx = clip_scale(x)
        xq = _quant_i8(x.float(), (1.0 / sx).float()[:, None, None])
        wq, s1 = conv1_weights(w1)
        mul = (a1[None] * s1)[None] * sx.float()[:, None, None]
        if quantize is True:
            return _int8_conv2(xq, wq, mul, b1, w2, (a2, b2), tc,
                               HALO[mode])
        acc = torch.einsum("btmk,mkc->btmc", _taps(xq.double()),
                           wq.double()).float()
        y1 = acc * mul[:, None] + b1
    else:
        wb = w1[:, :, 0, :].reshape(9, -1).to(compute_dtype).float()
        acc = torch.einsum("btmk,kc->btmc", _taps(x.float()), wb)
        y1 = acc * a1 + b1
    y1 = torch.relu(y1).to(compute_dtype)
    acc2 = F.conv2d(y1.float().permute(0, 3, 1, 2),
                    w2.to(compute_dtype).float().permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)
    y2 = torch.relu(acc2 * a2 + b2).to(compute_dtype)
    return _pool_bf16(y2)


def _int8_conv2(xq, wq, mul, b1, w2, ab2, tc: int,
                halo: int = 1) -> torch.Tensor:
    """``quantize=True`` after the int8 input: conv1 per chunk of ``tc``
    frames over times ``[j tc - halo, j tc + tc + halo)`` (``halo`` 1 for
    the triple staging, 2 for the single one), the chunk's y1 scale over
    all of those rows, requantize, zero the rows outside the clip, int8
    conv2, BN, ReLU, bf16 pool."""
    b, t, _ = xq.shape
    nch = -(-t // tc)
    tp = nch * tc
    rows = tc + 2 * halo
    xpad = F.pad(xq.double(), (0, 0, halo, tp + halo - t))
    acc = torch.einsum("btmk,mkc->btmc", _taps(xpad), wq.double()).float()
    y1 = torch.relu(acc * mul[:, None] + b1)        # times -halo .. tp+halo
    c = y1.shape[-1]
    win = y1.unfold(1, rows, tc).permute(0, 1, 4, 2, 3).reshape(
        b * nch, rows, _M, c)
    sy = over127(torch.clamp(win.amax(dim=(1, 2, 3)), min=1e-6))
    yq = _quant_i8(win, (1.0 / sy)[:, None, None, None])
    time = (torch.arange(nch, device=xq.device)[:, None] * tc - halo
            + torch.arange(rows, device=xq.device)[None])
    valid = ((time >= 0) & (time < t)).repeat(b, 1)[:, :, None, None]
    yq = torch.where(valid, yq, torch.zeros((), dtype=yq.dtype,
                                            device=yq.device))
    yq = yq[:, halo - 1:rows - halo + 1]          # conv2's rows: tc + 2
    w2q, s2 = quant_weight(w2.float())
    acc2 = _conv_valid_time(yq, w2q, torch.float64).float()
    mul2 = (ab2[0] * s2)[None] * sy[:, None]
    y2 = torch.relu(acc2 * mul2[:, None, None] + ab2[1]).to(torch.bfloat16)
    return _pool_bf16(y2.reshape(b, tp, _M, c))[:, :t // 2]


_P, _I = _build.P, _build.I
_ARGS = [_I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _P, _P]
_V2_ARGS = _ARGS[:12] + [_P] * 4
_MODES = {False: 0, "conv1": 1, True: 2}


def kernel_weights(w1, ab1, w2, ab2, quantize) -> tuple:
    """(w1, alpha1, beta1, w2 [64, 9 * 64], alpha2, beta2) in the kernel's
    layout: for ``"conv1"`` and ``True`` w1 is the banded int8 ``[64 mel,
    9, C]`` with its scales folded into alpha1 ``[64 mel, C]``, else bf16
    ``[9, C]``; w2 is int8 with its per-channel scales folded into alpha2
    for ``True``, else bf16, k = (dt * 3 + dm) * 64 + ci."""
    a1, b1 = (v.float().contiguous() for v in ab1)
    a2, b2 = (v.float().contiguous() for v in ab2)
    if quantize in ("conv1", True):
        wk1, s1 = conv1_weights(w1)
        ak1 = (a1[None] * s1).contiguous()
    else:
        wk1 = w1[:, :, 0, :].reshape(9, -1).to(torch.bfloat16).contiguous()
        ak1 = a1
    if quantize is True:
        wk2, s2 = quant_weight(w2.float())
        a2 = (a2 * s2).contiguous()
    else:
        wk2 = w2.to(torch.bfloat16)
    wk2 = wk2.permute(3, 0, 1, 2).reshape(64, -1)
    return wk1, ak1, b1, wk2.contiguous(), a2, b2


def check_mode(quantize, tc: int, mode: str = "triple"):
    """The mode as ``conv_block1_pair.py:373-384`` reads it (``"conv1"``,
    or any other value taken as a bool; the staging ``"triple"`` or
    ``"single"``), after the TPU kernel's limits on tc (``:397-398``)."""
    if mode not in HALO:
        raise ValueError(f"unknown block1 pair mode: {mode!r}")
    if tc % 16 or _M // 2 * (tc + 2) > 2200:
        raise ValueError(f"invalid tc={tc}: a multiple of 16, at most 64")
    if isinstance(quantize, str):
        if quantize != "conv1":
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        return quantize
    return bool(quantize)


def _check_args(x, w1, w2, quantize, tc, mode):
    quantize = check_mode(quantize, tc, mode)
    if x.dim() != 3 or x.shape[2] != _M or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError("x must be a contiguous [B, T, 64] bf16 tensor")
    if tuple(w1.shape) != (3, 3, 1, 64) or tuple(w2.shape) != (3, 3, 64, 64):
        raise ValueError("block 1 takes w1 [3, 3, 1, 64], w2 [3, 3, 64, 64]")
    return quantize


def scratch_v2(b: int, t: int, tc: int, quantize, device) -> tuple:
    """The second design's scratch: (smax, y1).  ``smax`` int32 holds the
    clips' x max bits, then under ``True`` the groups' y1 max bits (G = B
    ceil(T / tc) groups); y1 is conv2's mel-padded input: under ``False``
    ``[B, 2 (T // 2) + 2, 66, 64]`` bf16 (rows at times -1 .. 2 (T //
    2)), under ``True`` ``[G, tc + 2, 66, 64]`` int8 (times ``j tc - 1 ..
    j tc + tc``), and in ``"conv1"`` mode, which keeps y1 in shared
    memory, an empty tensor."""
    g = b * -(-t // tc) if quantize is True else 0
    smax = torch.empty(b + g, dtype=torch.int32, device=device)
    if quantize == "conv1":
        return smax, torch.empty(0, dtype=torch.int8, device=device)
    if quantize is True:
        return smax, torch.empty(g, tc + 2, _M + 2, 64, dtype=torch.int8,
                                 device=device)
    return smax, torch.empty(b, t // 2 * 2 + 2, _M + 2, 64,
                             dtype=torch.bfloat16, device=device)


def fused_block1_pair(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                      w2: torch.Tensor, ab2: tuple, *,
                      quantize="conv1", tc: int = 48,
                      mode: str = "triple",
                      prepared: tuple | None = None) -> torch.Tensor:
    """Fused (conv3x3 → BN → ReLU) × 2 → avg+max 2×2 pool for Cin = 1.

    x ``[B, T, 64]`` bf16 (the bn0 output); w1 ``[3, 3, 1, 64]``, w2
    ``[3, 3, 64, 64]`` HWIO f32; ab from :func:`fold_bn`; ``quantize``
    ``"conv1"``, ``False`` or ``True``; ``tc`` the chunk of the y1 scales
    under ``True``; ``mode`` the staging, ``"triple"`` or ``"single"``
    (its own y1 scale window under ``True``); ``prepared``, if given, is
    :func:`kernel_weights` of
    the same weights and mode, kept by the caller so that a forward does
    not lay them out again.  Returns ``[B, T // 2, 32, 64]`` bf16.
    Serving only (running BN statistics).
    """
    quantize = _check_args(x, w1, w2, quantize, tc, mode)
    check_device(x, w1, w2, *ab1, *ab2)
    if not x.is_cuda:
        return block1_plain(x, w1, ab1, w2, ab2, quantize=quantize, tc=tc,
                            mode=mode)
    wk = prepared or kernel_weights(w1, ab1, w2, ab2, quantize)
    b, t, _ = x.shape
    check_device(x, *wk)
    halo = HALO[mode] if quantize is True else 1
    smax, y1 = scratch_v2(b, t, tc, quantize, x.device)
    out = torch.empty(b, t // 2, _M // 2, 64, dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.function("conv_block1_v2", "ttg_conv_block1_v2", _V2_ARGS)
    err = fn(_MODES[quantize], halo, x.data_ptr(), b, t, tc,
             *(v.data_ptr() for v in wk), smax.data_ptr(), y1.data_ptr(),
             out.data_ptr(), _build.stream())
    launches["conv_block1_pair" if quantize is not True
             else f"conv_block1_pair_{mode.replace('triple', 'int8')}"] += 1
    _build.check(err, "ttg_conv_block1_v2")
    return out


def _fused_block1_pair_v1(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                          w2: torch.Tensor, ab2: tuple, *,
                          quantize="conv1", tc: int = 48,
                          mode: str = "triple",
                          prepared: tuple | None = None) -> torch.Tensor:
    """The first design (``csrc/conv_block1_pair.cu``) on a CUDA tensor,
    arguments as :func:`fused_block1_pair`, counted in
    ``launches["conv_block1_pair_v1"]``; nothing served calls it.
    ``chip_smoke.py`` holds the second design to it."""
    quantize = _check_args(x, w1, w2, quantize, tc, mode)
    if not x.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    b, t, _ = x.shape
    wk1, ak1, b1, wk2, a2, b2 = prepared or kernel_weights(
        w1, ab1, w2, ab2, quantize)
    check_device(x, wk1, ak1, b1, wk2, a2, b2)
    dev = x.device
    sx = torch.empty(b, 2, device=dev)
    halo = HALO[mode] if quantize is True else 1
    if quantize is True:
        g = b * -(-t // tc)
        y1 = torch.empty(g, tc + 2 * halo, _M, 64, device=dev)
        y1q = torch.empty(g, tc + 2 * halo, _M, 64, dtype=torch.int8,
                          device=dev)
        sy = torch.empty(g, device=dev)
    else:
        y1 = torch.empty(b, t, _M, 64, dtype=torch.bfloat16, device=dev)
        y1q = sy = torch.empty(1, device=dev)
    out = torch.empty(b, t // 2, _M // 2, 64, dtype=torch.bfloat16,
                      device=dev)
    fn = _build.function("conv_block1_pair", "ttg_conv_block1", _ARGS)
    err = fn(_MODES[quantize], halo, x.data_ptr(), b, t, tc,
             wk1.data_ptr(), ak1.data_ptr(), b1.data_ptr(), wk2.data_ptr(),
             a2.data_ptr(), b2.data_ptr(), sx.data_ptr(), y1.data_ptr(),
             y1q.data_ptr(), sy.data_ptr(), out.data_ptr(), _build.stream())
    launches["conv_block1_pair_v1"] += 1
    _build.check(err, "ttg_conv_block1")
    return out
