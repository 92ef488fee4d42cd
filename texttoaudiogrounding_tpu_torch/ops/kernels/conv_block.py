"""Fused PANNs conv block, direct 3x3 taps (serving path): ``csrc/conv_block.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block.py``:
(conv3x3 → BN → ReLU) × 2 → avg+max pool for one block, over chunks of
``tc`` output times, in int8 or bf16.  Blocks 3 and 4 of the Cnn8Rnn
serving path run through it.

int8 contract (``conv_block.py:435-461``, ``:312-328``):

* the input scale is per clip, ``max|x| / 127`` over the whole input,
  floored at 1e-6 before the division;
* conv1 rows are computed per chunk for times ``[t0 - 1, t0 + tc + 1)``,
  zeroed outside the clip; their scale is per (clip, chunk), so the halo
  rows are quantized with the chunk's own scale;
* weights are int8 per output channel (floor 1e-8), their scales folded
  into the BN affine; products accumulate exactly (int32 on the card,
  float64 in the plain version).

:func:`fused_double_conv_pool` launches the kernel for a CUDA tensor and
runs :func:`double_conv_plain` for a CPU tensor.  The plain version is the
same chunked arithmetic in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.kernels import _build

launches = 0          # kernel launches through fused_double_conv_pool


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BN(running stats) as per-channel affine: ``y = x * a + b``."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


def over127(v: torch.Tensor) -> torch.Tensor:
    """``v / 127`` as a true division, as the kernels and the JAX package
    compute it (PyTorch on the card multiplies by the reciprocal when the
    divisor is a Python scalar, which can differ by one ulp)."""
    return v / torch.full_like(v, 127.0)


def _quant_i8(x: torch.Tensor, inv) -> torch.Tensor:
    return torch.clamp(torch.round(x * inv), -127.0, 127.0).to(torch.int8)


def quant_weight(w: torch.Tensor, divide: bool = False) -> tuple:
    """Per-output-channel int8 quantization of HWIO ``[3, 3, Cin, Cout]``
    weights: ``(int8 weights, scales [Cout])``.  The weights are
    multiplied by the scales' reciprocals, or with ``divide`` divided by
    the scales, as ``conv_block_small.py:75 _quant_rows`` does in numpy
    (the two can round a weight to neighbouring integers)."""
    s = over127(torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-8))
    if divide:
        return torch.clamp(torch.round(w / s), -127.0, 127.0).to(
            torch.int8), s
    return _quant_i8(w, 1.0 / s), s


def _vmem_bytes(t, m, cin, cout, pt, pm, tc, quantize, compute_dtype):
    """The TPU kernel's VMEM estimate in direct9 mode
    (``conv_block.py:62``)."""
    isize = compute_dtype.itemsize
    wsize = 1 if quantize else isize
    rows1 = (tc + 2) * m
    rows2 = tc * m
    return (
        2 * t * m * cin * isize
        + 2 * (tc // pt) * (m // pm) * cout * 2
        + (t + 4) * m * cin * isize
        + (tc + 4) * m * cin * isize
        + (rows1 + 2) * cout * isize
        + rows1 * cout * 4 + rows2 * cout * 4
        + 2 * rows2 * cout * 4
        + (9 * cin * cout + 9 * cout * cout) * wsize)


def _pick_tc(t, m, cin, cout, pt, pm, quantize,
             compute_dtype=torch.bfloat16, max_rows: int = 2000,
             budget: int = 15 * 2**20 + 2**19) -> int:
    """The JAX package's chunk rule (``conv_block.py:88``) for direct9:
    the largest tc dividing t, a multiple of pt, with ``tc * m <=
    max_rows``, a pooled block of a multiple of 8 rows and the TPU
    kernel's VMEM estimate within budget.  The chunk fixes where the y1
    scales change, so the port takes the same tc."""
    best = 0
    smallest = 0
    for c in range(pt, t + 1, pt):
        if ((t // pt) % (c // pt) == 0 and c * m <= max_rows
                and ((c // pt) * (m // pm)) % 8 == 0):
            smallest = smallest or c
            if _vmem_bytes(t, m, cin, cout, pt, pm, c, quantize,
                           compute_dtype) <= budget:
                best = c
    best = best or smallest
    if best == 0:
        raise ValueError(
            f"no valid chunk size for T={t} M={m} {cin}->{cout}")
    return best


def pick_tc(t, m, cin, cout, pt, pm, quantize) -> int:
    """:func:`_pick_tc`, or, for the shapes where it raises (the JAX
    package then runs the XLA block instead of the kernel), the port's own
    rule: the largest multiple of pt with ``tc * m <= 2000``, the last
    chunk ragged.  The port runs its kernel for every shape."""
    try:
        return _pick_tc(t, m, cin, cout, pt, pm, quantize)
    except ValueError:
        return max(pt, (2000 // m) // pt * pt)


def _windows(x: torch.Tensor, tc: int, halo: int, nch: int) -> torch.Tensor:
    """``[B, T, ...]`` → ``[B * nch, tc + 2 halo, ...]``: chunk j holds
    times ``[j tc - halo, j tc + tc + halo)``, zero outside the clip."""
    b, t = x.shape[:2]
    pad = (0, 0) * (x.dim() - 2) + (halo, nch * tc - t + halo)
    xp = F.pad(x, pad)
    w = xp.unfold(1, tc + 2 * halo, tc)                # [B, nch, ..., W]
    w = w.permute(0, 1, w.dim() - 1, *range(2, w.dim() - 1))
    return w.reshape(b * nch, tc + 2 * halo, *x.shape[2:])


def _conv_valid_time(x: torch.Tensor, w: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """``[G, R, M, Cin]`` ⊛ HWIO ``[3, 3, Cin, Cout]`` → ``[G, R-2, M,
    Cout]``: no padding in time (the rows carry their halo), zero padding
    in mel."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype),
                 w.permute(3, 2, 0, 1).to(dtype), padding=(0, 1))
    return y.permute(0, 2, 3, 1)


def dual_pool(y: torch.Tensor, pt: int, pm: int) -> torch.Tensor:
    """f32 avg+max pool of ``[G, R, M, C]``: mel pairs, then time pairs,
    ``sum / (pt pm) + max`` (``conv_block.py:114 _dual_pool``)."""
    g, r, m, c = y.shape
    v = y.reshape(g, r // pt, pt, m // pm, pm, c)
    if pm == 2:
        s, mx = v[..., 0, :] + v[..., 1, :], torch.maximum(v[..., 0, :],
                                                           v[..., 1, :])
    else:
        s = mx = v[..., 0, :]
    if pt == 2:
        s, mx = s[:, :, 0] + s[:, :, 1], torch.maximum(mx[:, :, 0],
                                                       mx[:, :, 1])
    else:
        s, mx = s[:, :, 0], mx[:, :, 0]
    return s * (1.0 / (pt * pm)) + mx


def per_clip_scale(xf: torch.Tensor, tc: int, nch: int) -> torch.Tensor:
    """``[B, nch]`` input scales, one per clip, repeated over its chunks."""
    s = over127(torch.clamp(xf.abs().amax(dim=(1, 2, 3)), min=1e-6))
    return s[:, None].expand(-1, nch)


def double_conv_plain(x, w1, ab1, w2, ab2, pool, *, quantize: bool,
                      tc: int, x_scale=per_clip_scale,
                      compute_dtype=torch.bfloat16, round_y1: bool = False,
                      divide: bool = False) -> torch.Tensor:
    """The chunked int8 / bf16 block in plain PyTorch.

    x ``[B, T, M, Cin]`` bf16; w HWIO f32; ab folded BN affines.
    ``x_scale(x_f32, tc, nch) -> [B, nch]`` gives the input scale of each
    chunk (per clip here, per chunk window for block 2).  Without
    ``quantize`` the convolutions take ``compute_dtype`` operands (f32
    sums) and the result is in that type.  ``round_y1`` rounds the conv1
    rows to ``compute_dtype`` before their int8 scale is taken
    (``conv_block.py:691 fused_pair_conv_pool`` stores them so);
    ``divide`` as in :func:`quant_weight`.
    Returns ``[B, T // pt, M // pm, Cout]``, bf16 for int8.
    """
    b, t, m, _ = x.shape
    nch = -(-t // tc)
    g = b * nch
    a1, b1 = (v.float() for v in ab1)
    time = (torch.arange(nch, device=x.device)[:, None] * tc - 1
            + torch.arange(tc + 2, device=x.device)[None])
    valid = ((time >= 0) & (time < t)).repeat(b, 1)[:, :, None, None]
    if quantize:
        xf = x.float()
        sx = x_scale(xf, tc, nch).reshape(g)
        xq = _quant_i8(_windows(xf, tc, 2, nch),
                       (1.0 / sx).reshape(g, 1, 1, 1))
        w1q, s1 = quant_weight(w1.float(), divide)
        # int8 products summed exactly: float64 holds every partial sum
        acc1 = _conv_valid_time(xq, w1q, torch.float64).float()
        mul1 = (a1 * s1)[None] * sx[:, None]
        y1 = torch.where(valid, torch.relu(acc1 * mul1[:, None, None] + b1),
                         0.0)
        if round_y1:
            y1 = y1.to(compute_dtype).float()
    else:
        xw = _windows(x.to(compute_dtype), tc, 2, nch)
        acc1 = _conv_valid_time(xw, w1.to(compute_dtype), torch.float32)
        y1 = torch.where(valid, torch.relu(acc1 * a1 + b1), 0.0)
    return conv2_pool_plain(y1, w2, ab2, pool, b, t, quantize=quantize,
                            compute_dtype=compute_dtype, divide=divide)


def conv2_pool_plain(y1, w2, ab2, pool, b: int, t: int, *, quantize: bool,
                     compute_dtype=torch.bfloat16,
                     divide: bool = False) -> torch.Tensor:
    """The second half of a chunked block: y1 ``[B * nch, tc + 2, M, C]``
    f32, conv1 rows at times ``[j tc - 1, j tc + tc + 1)`` of chunk j,
    zero outside the clip → requantize per chunk (int8) → conv2 → BN →
    ReLU → f32 avg+max pool → ``[B, T // pt, M // pm, Cout]``."""
    g, r, m, _ = y1.shape
    nch, tc = g // b, r - 2
    cout = w2.shape[-1]
    pt, pm = pool
    a2, b2 = (v.float() for v in ab2)
    if quantize:
        sy = over127(torch.clamp(y1.amax(dim=(1, 2, 3)), min=1e-6))
        y1q = _quant_i8(y1, (1.0 / sy).reshape(g, 1, 1, 1))
        w2q, s2 = quant_weight(w2.float(), divide)
        acc2 = _conv_valid_time(y1q, w2q, torch.float64).float()
        mul2 = (a2 * s2)[None] * sy[:, None]
        y2 = torch.relu(acc2 * mul2[:, None, None] + b2)
    else:
        acc2 = _conv_valid_time(y1.to(compute_dtype),
                                w2.to(compute_dtype), torch.float32)
        y2 = torch.relu(acc2 * a2 + b2)
    pooled = dual_pool(y2, pt, pm)
    pooled = pooled.reshape(b, nch * tc // pt, m // pm, cout)[:, :t // pt]
    return pooled.to(torch.bfloat16 if quantize else compute_dtype)


def conv_weights(w, ab, quantize: bool, divide: bool = False) -> tuple:
    """One conv's (w [Cout, 9 Cin], alpha, beta) in the kernel's layout:
    k = (dt * 3 + dm) * Cin + ci; int8 with the weight scales folded into
    alpha (``divide`` as in :func:`quant_weight`), or bf16."""
    w = w.float()
    a = ab[0].float()
    if quantize:
        w, s = quant_weight(w, divide)
        a = a * s
    else:
        w = w.to(torch.bfloat16)
    return (w.permute(3, 0, 1, 2).reshape(w.shape[3], -1).contiguous(),
            a.contiguous(), ab[1].float().contiguous())


def kernel_weights(w1, ab1, w2, ab2, quantize: bool,
                   divide: bool = False) -> tuple:
    """(w1 [Cout, 9 Cin], alpha1, beta1, w2 [Cout, 9 Cout], alpha2,
    beta2): :func:`conv_weights` of both convs."""
    return (conv_weights(w1, ab1, quantize, divide)
            + conv_weights(w2, ab2, quantize, divide))


def check_device(x: torch.Tensor, *tensors) -> None:
    """Weights and affines must lie on the activations' device."""
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"a {t.device} tensor given with x on "
                             f"{x.device}")


def check_block_args(x, w1, ab1, w2, ab2, pool, tc) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [B, T, M, Cin] bf16 tensor")
    check_device(x, w1, w2, *ab1, *ab2)
    cin, cout = x.shape[3], w1.shape[-1]
    if tuple(w1.shape) != (3, 3, cin, cout) or \
            tuple(w2.shape) != (3, 3, cout, cout):
        raise ValueError("weights must be HWIO [3, 3, Cin, Cout]")
    pt, pm = pool
    if pt not in (1, 2) or pm not in (1, 2) or x.shape[2] % pm:
        raise ValueError(f"unsupported pool {pool} for M={x.shape[2]}")
    if tc < pt or tc % pt:
        raise ValueError(f"tc={tc} must be a positive multiple of {pt}")
    if x.is_cuda and (cin % 64 or cout % 64):
        raise ValueError("the kernel takes Cin and Cout multiples of 64")


def scratch(b, t, m, cin, cout, tc, quantize, device) -> tuple:
    """(xs, y1, y1q, sx, sy) device buffers of the chunked pipeline."""
    g = b * -(-t // tc)
    act = torch.int8 if quantize else torch.bfloat16
    return (torch.empty(g, tc + 4, m, cin, dtype=act, device=device),
            torch.empty(g, tc + 2, m, cout, device=device,
                        dtype=torch.float32 if quantize else torch.bfloat16),
            torch.empty(g, tc + 2, m, cout, dtype=torch.int8, device=device)
            if quantize else torch.empty(1, dtype=torch.int8, device=device),
            torch.empty(g, device=device), torch.empty(g, device=device))


_P, _I = _build.P, _build.I
_ARGS = [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]


def fused_double_conv_pool(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                           w2: torch.Tensor, ab2: tuple,
                           pool: tuple = (2, 2), *, quantize: bool = False,
                           tc: int | None = None,
                           prepared: tuple | None = None) -> torch.Tensor:
    """Fused (conv3x3 → BN → ReLU) × 2 → avg+max pool.

    x ``[B, T, M, Cin]`` bf16; w ``[3, 3, Cin, Cout]`` HWIO f32; ab
    ``(a, b)`` from :func:`fold_bn`; ``prepared``, if given, is
    :func:`kernel_weights` of the same weights, kept by the caller so that
    a forward does not lay them out again.  Returns ``[B, T // pt,
    M // pm, Cout]`` bf16.  Serving only (running BN statistics).
    """
    global launches
    b, t, m, cin = x.shape
    cout = w1.shape[-1]
    pt, pm = pool
    tc = tc or pick_tc(t, m, cin, cout, pt, pm, quantize)
    check_block_args(x, w1, ab1, w2, ab2, pool, tc)
    if not x.is_cuda:
        return double_conv_plain(x, w1, ab1, w2, ab2, pool,
                                 quantize=quantize, tc=tc)
    wk = prepared or kernel_weights(w1, ab1, w2, ab2, quantize)
    check_device(x, *wk)
    xs, y1, y1q, sx, sy = scratch(b, t, m, cin, cout, tc, quantize,
                                  x.device)
    out = torch.empty(b, t // pt, m // pm, cout, dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.function("conv_block", "ttg_conv_block", _ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, cin, cout, tc, pt, pm,
             *(v.data_ptr() for v in wk), xs.data_ptr(), y1.data_ptr(),
             y1q.data_ptr(), sx.data_ptr(), sy.data_ptr(), out.data_ptr(),
             _build.stream())
    launches += 1
    _build.check(err, "ttg_conv_block")
    return out
