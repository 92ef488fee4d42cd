"""Fused PANNs conv block (serving path): ``csrc/conv_block_v2.cu``,
``csrc/conv_block_tri_v2.cu`` and ``csrc/conv_block_mel3_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block.py:370``:
(conv3x3 → BN → ReLU) × 2 → avg+max pool for one block, over chunks of
``tc`` output times, in int8 or bf16.  Blocks 3 and 4 of the Cnn8Rnn
serving path run through it in direct 3x3 taps (direct9).  Each conv can
instead run in the TPU kernel's ``mel3`` or ``tri`` tap mode (a mel-im2col
of K = 3 Cin and three time-tap products), which no shipped model routes;
on the card both run the slab form of the wgmma implicit GEMM
(``csrc/conv_block_tri_v2.cu``, and for ``mel3``'s int8 scales
``csrc/conv_block_mel3_v2.cu``; :func:`slab_plan` says which shapes go
where).

int8 contract (``conv_block.py:435-461``, ``:312-328``):

* the input scale is per clip, ``max|x| / 127`` over the whole input,
  floored at 1e-6 before the division;
* conv1 rows are computed per chunk for times ``[t0 - 1, t0 + tc + 1)``,
  zeroed outside the clip; their scale is per (clip, chunk), so the halo
  rows are quantized with the chunk's own scale;
* weights are int8 per output channel (floor 1e-8), their scales folded
  into the BN affine; products accumulate exactly (int32 on the card,
  float64 in the plain version).

The tap modes' own int8 scales (``:162 _mel3_build``, ``:286-341``):

* a ``mel3`` conv1 takes no per-clip input: its scale is per chunk, over
  the flat (t, mel) cells ``[(j tc - 2) M - 1, (j tc + tc + 2) M + 1)`` of
  the clip (:func:`mel3_window_scale`, the staged window ``xc_ref``);
* a ``mel3`` conv2 after a ``mel3`` conv1 takes y1 stored in bf16, and
  its per-chunk scale is taken over those rounded values;
* ``tri`` keeps direct9's scales (per-clip x, per-chunk f32 y1), so its
  int8 result is direct9's at the same ``tc``.

The chunk ``tc`` follows the TPU kernel's VMEM estimate of the mode
(:func:`_pick_tc`), which counts the im2col buffers, so each mode has its
own ``tc`` and with it its own int8 scales.

:func:`fused_double_conv_pool` launches a kernel for a CUDA tensor and
runs :func:`block_plain` for a CPU tensor: the same chunked arithmetic in
plain PyTorch (:func:`double_conv_plain`).  In direct9 the kernel is the
second design, the wgmma implicit GEMM of ``csrc/conv_igemm_sm90.cuh``;
the first design (``csrc/conv_block.cu``, WMMA tiles on one-block-per-group
gathers) gives the same int8 result bit for bit and is reachable only
through :func:`_fused_double_conv_pool_v1`, which ``chip_smoke.py`` times
beside it; so are the tap modes' first design (``csrc/conv_block_mel3.cu``,
a WMMA slab GEMM) through :func:`_fused_mel3_v1` and :func:`_fused_tri_v1`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.kernels import _build

# kernel launches through fused_double_conv_pool: direct9 (the serving
# path, second design); mel3 and tri on the wgmma slab form, or on
# direct9's per-tap GEMM at the mode's chunk where the slab form takes
# neither conv (tri_route); the first designs of direct9
# (_fused_double_conv_pool_v1), mel3 (_fused_mel3_v1) and tri
# (_fused_tri_v1), which M 2 / 4 with time pairs also run (direct9's first
# design also where v2_takes says no)
launches = {"conv_block": 0, "conv_block_mel3": 0,
            "conv_block_mel3_per_tap": 0, "conv_block_mel3_v1": 0,
            "conv_block_tri": 0, "conv_block_tri_per_tap": 0,
            "conv_block_tri_v1": 0, "conv_block_v1": 0}
SLAB_M = (8, 16, 32, 64)   # M of the tri slab form: whole swizzle atoms
SLAB_BM = 128              # output rows of its GEMM tile


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


def _vmem_bytes(t, m, cin, cout, pt, pm, tc, quantize, compute_dtype,
                mel3=(False, False)):
    """The TPU kernel's VMEM estimate (``conv_block.py:62``); ``mel3``
    marks the convs that stage an im2col (mel3 or tri)."""
    isize = compute_dtype.itemsize
    qsize = 1 if quantize else isize
    wsize = 1 if quantize else isize
    rows1 = (tc + 2) * m
    rows2 = tc * m
    rows_x = (tc + 4) * m
    k1 = 3 * cin if mel3[0] else cin
    k2 = 3 * cout if mel3[1] else cout
    xc3 = rows_x * k1 * qsize if mel3[0] else 0
    y2c = rows1 * k2 * qsize if mel3[1] else 0
    w1n = 3 * k1 * cout if mel3[0] else 9 * cin * cout
    w2n = 3 * k2 * cout if mel3[1] else 9 * cout * cout
    return (
        2 * t * m * cin * isize
        + 2 * (tc // pt) * (m // pm) * cout * 2
        + (t + 4) * m * cin * isize
        + (tc + 4) * m * cin * isize
        + xc3 + y2c
        + (rows1 + 2) * cout * isize
        + rows1 * cout * 4 + rows2 * cout * 4
        + 2 * rows2 * cout * 4
        + (w1n + w2n) * wsize)


def _pick_tc(t, m, cin, cout, pt, pm, quantize,
             compute_dtype=torch.bfloat16, mel3=(False, False),
             max_rows: int = 2000,
             budget: int = 15 * 2**20 + 2**19) -> int:
    """The JAX package's chunk rule (``conv_block.py:88``): the largest tc
    dividing t, a multiple of pt, with ``tc * m <= max_rows``, a pooled
    block of a multiple of 8 rows and the TPU kernel's VMEM estimate for
    the tap modes ``mel3`` within budget.  The chunk fixes where the int8
    scales change, so the port takes the same tc."""
    best = 0
    smallest = 0
    for c in range(pt, t + 1, pt):
        if ((t // pt) % (c // pt) == 0 and c * m <= max_rows
                and ((c // pt) * (m // pm)) % 8 == 0):
            smallest = smallest or c
            if _vmem_bytes(t, m, cin, cout, pt, pm, c, quantize,
                           compute_dtype, mel3) <= budget:
                best = c
    best = best or smallest
    if best == 0:
        raise ValueError(
            f"no valid chunk size for T={t} M={m} {cin}->{cout}")
    return best


def pick_tc(t, m, cin, cout, pt, pm, quantize, mel3=(False, False),
            compute_dtype=torch.bfloat16) -> int:
    """:func:`_pick_tc`, or, for the shapes where it raises (the JAX
    package then runs the XLA block instead of the kernel), the port's own
    rule: the largest multiple of pt with ``tc * m <= 2000``, the last
    chunk ragged.  The port runs its kernel for every shape."""
    try:
        return _pick_tc(t, m, cin, cout, pt, pm, quantize, compute_dtype,
                        mel3)
    except ValueError:
        return max(pt, (2000 // m) // pt * pt)


def tap_modes(cin: int, quantize: bool, mel3=None, tri=None) -> tuple:
    """``(mel3_1, mel3_2, tri_1, tri_2)`` by the JAX wrapper's rule
    (``conv_block.py:415-428``): ``mel3`` defaults to ``(not quantize and
    cin < 128, False)``; ``tri`` clears ``mel3`` conv by conv; int8 with a
    mel3 conv2 after a direct conv1 is rejected."""
    if mel3 is None:
        mel3 = (not quantize and cin < 128, False)
    mel3_1, mel3_2 = mel3
    tri_1, tri_2 = tri if tri is not None else (False, False)
    mel3_1, mel3_2 = mel3_1 and not tri_1, mel3_2 and not tri_2
    if quantize and mel3_2 and not mel3_1:
        raise ValueError(
            "quantize=True with mel3=(False, True) is unsupported: int8 "
            "direct9 conv1 stores an int8 y1 whose dynamic scale the mel3 "
            "conv2 staging does not consume; use (False, False) or "
            "(True, True)")
    return bool(mel3_1), bool(mel3_2), bool(tri_1), bool(tri_2)


def block_tc(x_shape, cout: int, pool, quantize: bool, modes: tuple,
             compute_dtype=torch.bfloat16) -> int:
    """The chunk of :func:`fused_double_conv_pool` for ``modes`` (from
    :func:`tap_modes`): the JAX rule on the staged convs, with Cin padded
    to 128 where the JAX wrapper pads the per-clip int8 input
    (``conv_block.py:445-448``)."""
    _, t, m, cin = x_shape
    mel3_1, mel3_2, tri_1, tri_2 = modes
    if quantize and not mel3_1:
        cin = max(cin, 128)
    return pick_tc(t, m, cin, cout, pool[0], pool[1], quantize,
                   (mel3_1 or tri_1, mel3_2 or tri_2), compute_dtype)


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


def window_scale(xf: torch.Tensor, tc: int, nch: int, lead: int,
                 size: int) -> torch.Tensor:
    """``[B, nch]`` input scales of ``[B, T, R, C]``: max |x| over each
    chunk's window of flat (t, r) cells ``[j tc R - lead, j tc R - lead +
    size)`` of the clip."""
    b, t, r, _ = xf.shape
    cells = xf.abs().amax(dim=-1).reshape(b, t * r)
    tail = max(0, (nch - 1) * tc * r + size - lead - t * r)
    win = F.pad(cells, (lead, tail)).unfold(1, size, tc * r)[:, :nch]
    return over127(torch.clamp(win.amax(dim=-1), min=1e-6))


def mel3_window_scale(xf: torch.Tensor, tc: int, nch: int) -> torch.Tensor:
    """A mel3 conv1's ``[B, nch]`` input scales: the staged window of
    chunk j, times ``[j tc - 2, j tc + tc + 2)`` and one cell either side,
    ``(j tc - 3, M - 1)`` and ``(j tc + tc + 2, 0)``."""
    m = xf.shape[2]
    return window_scale(xf, tc, nch, 2 * m + 1, (tc + 4) * m + 2)


def double_conv_plain(x, w1, ab1, w2, ab2, pool, *, quantize: bool,
                      tc: int, x_scale=per_clip_scale,
                      compute_dtype=torch.bfloat16, round_y1: bool = False,
                      divide: bool = False,
                      conv=_conv_valid_time) -> torch.Tensor:
    """The chunked int8 / bf16 block in plain PyTorch.

    x ``[B, T, M, Cin]`` bf16; w HWIO f32; ab folded BN affines.
    ``x_scale(x_f32, tc, nch) -> [B, nch]`` gives the input scale of each
    chunk (per clip here, per chunk window for block 2).  Without
    ``quantize`` the convolutions take ``compute_dtype`` operands (f32
    sums) and the result is in that type.  ``round_y1`` rounds the conv1
    rows to ``compute_dtype`` before their int8 scale is taken
    (``conv_block.py:691 fused_pair_conv_pool`` stores them so);
    ``divide`` as in :func:`quant_weight`; ``conv`` replaces
    :func:`_conv_valid_time` (an emulated kernel blocking).
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
        acc1 = conv(xq, w1q, torch.float64).float()
        mul1 = (a1 * s1)[None] * sx[:, None]
        y1 = torch.where(valid, torch.relu(acc1 * mul1[:, None, None] + b1),
                         0.0)
        if round_y1:
            y1 = y1.to(compute_dtype).float()
    else:
        xw = _windows(x.to(compute_dtype), tc, 2, nch)
        acc1 = conv(xw, w1.to(compute_dtype), torch.float32)
        y1 = torch.where(valid, torch.relu(acc1 * a1 + b1), 0.0)
    return conv2_pool_plain(y1, w2, ab2, pool, b, t, quantize=quantize,
                            compute_dtype=compute_dtype, divide=divide,
                            conv=conv)


def block_plain(x, w1, ab1, w2, ab2, pool, *, quantize: bool, tc: int,
                modes: tuple = (False,) * 4,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`double_conv_plain` with the int8 scales of the tap ``modes``
    (:func:`tap_modes`): a mel3 conv1's per-chunk window scale, a mel3
    conv2's bf16-stored y1.  In bf16 or f32, and for tri, the modes compute
    direct9's sums."""
    mel3_1, mel3_2 = modes[:2]
    return double_conv_plain(
        x, w1, ab1, w2, ab2, pool, quantize=quantize, tc=tc,
        x_scale=mel3_window_scale if quantize and mel3_1 else per_clip_scale,
        compute_dtype=compute_dtype, round_y1=quantize and mel3_2)


def conv2_pool_plain(y1, w2, ab2, pool, b: int, t: int, *, quantize: bool,
                     compute_dtype=torch.bfloat16, divide: bool = False,
                     conv=_conv_valid_time) -> torch.Tensor:
    """The second half of a chunked block: y1 ``[B * nch, tc + 2, M, C]``
    f32, conv1 rows at times ``[j tc - 1, j tc + tc + 1)`` of chunk j,
    zero outside the clip → requantize per chunk (int8) → conv2 → BN →
    ReLU → f32 avg+max pool → ``[B, T // pt, M // pm, Cout]``; ``conv``
    as in :func:`double_conv_plain`."""
    g, r, m, _ = y1.shape
    nch, tc = g // b, r - 2
    cout = w2.shape[-1]
    pt, pm = pool
    a2, b2 = (v.float() for v in ab2)
    if quantize:
        sy = over127(torch.clamp(y1.amax(dim=(1, 2, 3)), min=1e-6))
        y1q = _quant_i8(y1, (1.0 / sy).reshape(g, 1, 1, 1))
        w2q, s2 = quant_weight(w2.float(), divide)
        acc2 = conv(y1q, w2q, torch.float64).float()
        mul2 = (a2 * s2)[None] * sy[:, None]
        y2 = torch.relu(acc2 * mul2[:, None, None] + b2)
    else:
        acc2 = conv(y1.to(compute_dtype), w2.to(compute_dtype),
                    torch.float32)
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


def check_block_args(x, w1, ab1, w2, ab2, pool, tc,
                     dtype=torch.bfloat16) -> None:
    if x.dim() != 4 or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, M, Cin] {dtype} "
                         f"tensor")
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


def scratch(b, t, m, cin, cout, tc, quantize, device,
            y1_half: bool = False) -> tuple:
    """(xs, y1, y1q, sx, sy) device buffers of the chunked pipeline; y1 is
    f32 for int8 unless ``y1_half``."""
    g = b * -(-t // tc)
    act = torch.int8 if quantize else torch.bfloat16
    return (torch.empty(g, tc + 4, m, cin, dtype=act, device=device),
            torch.empty(g, tc + 2, m, cout, device=device,
                        dtype=torch.float32 if quantize and not y1_half
                        else torch.bfloat16),
            torch.empty(g, tc + 2, m, cout, dtype=torch.int8, device=device)
            if quantize else torch.empty(1, dtype=torch.int8, device=device),
            torch.empty(g, device=device), torch.empty(g, device=device))


def scratch_v2(b, t, m, cin, cout, tc, quantize, device,
               per_clip: bool, y1_half: bool = False) -> tuple:
    """(xs, y1, y1q, smax) device buffers of the second design: xs and y1q
    with one zero mel column on each side (``[G, rows, M + 2, C]``); y1
    ``[G, tc + 2, M, Cout]`` for int8, f32 or with ``y1_half`` bf16, else
    the mel-padded bf16 conv2 input; smax the x scale maxes (one a clip
    with ``per_clip``, else one a group), then the y1 maxes, as float
    bits."""
    g = b * -(-t // tc)
    act = torch.int8 if quantize else torch.bfloat16
    xs = torch.empty(g, tc + 4, m + 2, cin, dtype=act, device=device)
    if quantize:
        y1 = torch.empty(g, tc + 2, m, cout, device=device,
                         dtype=torch.bfloat16 if y1_half else torch.float32)
        y1q = torch.empty(g, tc + 2, m + 2, cout, dtype=torch.int8,
                          device=device)
        smax = torch.empty((b if per_clip else g) + g, dtype=torch.int32,
                           device=device)
    else:
        y1 = torch.empty(g, tc + 2, m + 2, cout, dtype=torch.bfloat16,
                         device=device)
        y1q = smax = torch.empty(1, dtype=torch.int32, device=device)
    return xs, y1, y1q, smax


def v2_takes(m: int, pool) -> bool:
    """Whether the second design's GEMM takes pool ``pool`` at M mels: it
    pools time pairs inside a thread, so a 128-row tile must hold whole
    windows of 8-mel groups, M 8, 16, 32 or 64.  Rows 3, 4 direct9, 5 and
    6 run their first designs (counted under their ``_v1`` keys) where it
    says no."""
    return pool[0] != 2 or m in (8, 16, 32, 64)


def check_v2_pool(m: int, pool) -> None:
    """Raise where :func:`v2_takes` says no: the v2 launch helpers' guard."""
    if not v2_takes(m, pool):
        raise ValueError(f"the kernel takes time-pair pooling for M in "
                         f"(8, 16, 32, 64); got M={m}")


def tri_route(m: int, pool, tri_1: bool, tri_2: bool,
              mode: str = "tri") -> tuple:
    """``(slab1, slab2, key)`` of a tri (or mel3: ``mode``) block on the
    card, ``tri_1`` / ``tri_2`` marking the convs of either tap mode: which
    convs run the wgmma GEMM's slab form and the launch counter.  The slab
    form takes M in :data:`SLAB_M` (its time taps are row offsets of whole
    swizzle atoms) and, for conv2, pool (1, .) (its rows are not permuted
    for time pairs).  Where it takes neither conv, the block runs direct9's
    per-tap GEMM at the mode's chunk with the mode's scales
    (``"conv_block_<mode>_per_tap"``); at M 2 or 4 with time pairs, which
    neither GEMM takes, it runs the first slab design
    (``csrc/conv_block_mel3.cu``, ``"conv_block_<mode>_v1"``)."""
    ok = m in SLAB_M
    slab1, slab2 = bool(tri_1 and ok), bool(tri_2 and ok and pool[0] == 1)
    if slab1 or slab2:
        return slab1, slab2, f"conv_block_{mode}"
    if pool[0] == 1 or ok:
        return False, False, f"conv_block_{mode}_per_tap"
    return False, False, f"conv_block_{mode}_v1"


def slab_plan(modes: tuple, quantize: bool, m: int, pool) -> tuple:
    """``(design, slab1, slab2, key)`` of a block with a mel3 or tri conv
    (``modes`` from :func:`tap_modes`) on the card: :func:`tri_route` by
    shape, and the design that runs it: ``"v1"`` the first slab design,
    ``"mel3_v2"`` mel3's int8 second design (its own x window and
    bf16-stored y1, ``csrc/conv_block_mel3_v2.cu``), else ``"tri_v2"``
    (``csrc/conv_block_tri_v2.cu``), which also runs mel3's bf16 mode:
    there the two modes are one function at one chunk."""
    mel3_1, mel3_2, tri_1, tri_2 = modes
    mode = "mel3" if mel3_1 or mel3_2 else "tri"
    slab1, slab2, key = tri_route(m, pool, mel3_1 or tri_1, mel3_2 or tri_2,
                                  mode)
    if key.endswith("_v1"):
        design = "v1"
    elif mode == "mel3" and quantize:
        design = "mel3_v2"
    else:
        design = "tri_v2"
    return design, slab1, slab2, key


def check_tri_slab(m: int, pool, slab1: bool, slab2: bool) -> None:
    """Raise on a conv the slab form does not take (:func:`tri_route`)."""
    if (slab1 or slab2) and m not in SLAB_M:
        raise ValueError(f"the tri slab GEMM takes M in {SLAB_M}; got M={m}")
    if slab2 and pool[0] != 1:
        raise ValueError(f"the tri slab GEMM's conv2 takes pool (1, .); "
                         f"got {tuple(pool)}")


def slab_rows(n_pos: int, m: int, p0: int) -> torch.Tensor:
    """The slab of the tile at output position ``p0`` of the slab form:
    flat source rows ``p0 - M + q``, ``q < 128 + 2M``, as (time row * M +
    mel) of the halo-padded source, clamped into ``[0, n_pos)``.  Tap dt
    of tile row k reads slab row ``dt M + k``."""
    return (p0 - m + torch.arange(SLAB_BM + 2 * m)).clamp(0, n_pos - 1)


def slab_conv_emulated(x: torch.Tensor, w: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """:func:`_conv_valid_time` in the slab form's blocking: output
    positions ``(g R + r') M + m`` of ``x [G, R, M, Cin]`` in tiles of 128
    rows that cross group edges; for each mel tap dm one slab of mel-padded
    cells (column ``mel + dm``); the time taps dt read it ``dt M`` rows
    on; rows ``r'`` 0 and ``R - 1`` of each group are junk and dropped.
    Sums in ``dtype`` (float64: exact for int8).  → ``[G, R - 2, M,
    Cout]``."""
    g, r, m, cin = x.shape
    cells = F.pad(x, (0, 0, 1, 1)).reshape(-1, cin).to(dtype)
    wd = w.to(dtype)
    n_pos = g * r * m
    acc = torch.empty(n_pos, w.shape[3], dtype=dtype)
    for p0 in range(0, n_pos, SLAB_BM):
        f = slab_rows(n_pos, m, p0)
        tile = 0.0
        for dm in range(3):
            slab = cells[(f // m) * (m + 2) + f % m + dm]
            for dt in range(3):
                tile = tile + slab[dt * m:dt * m + SLAB_BM] @ wd[dt, dm]
        end = min(p0 + SLAB_BM, n_pos)
        acc[p0:end] = tile[:end - p0]
    return acc.reshape(g, r, m, -1)[:, 1:r - 1]


def tri_slab_emulated(x, w1, ab1, w2, ab2, pool, *, quantize: bool, tc: int,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The second tri design, tri=(True, True), on the CPU: direct9's
    scales and epilogues with both convs in :func:`slab_conv_emulated`."""
    return double_conv_plain(x, w1, ab1, w2, ab2, pool, quantize=quantize,
                             tc=tc, compute_dtype=compute_dtype,
                             conv=slab_conv_emulated)


_P, _I = _build.P, _build.I
_ARGS = [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_SLAB_ARGS = [_I] * 5 + _ARGS[1:]
_V2_ARGS = _ARGS[:16] + [_P] * 6
_TRI_ARGS = [_I] * 3 + _V2_ARGS[1:]    # also mel3's (y1_half for quant)


def fused_double_conv_pool(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                           w2: torch.Tensor, ab2: tuple,
                           pool: tuple = (2, 2), *, quantize: bool = False,
                           tc: int | None = None, mel3: tuple | None = None,
                           tri: tuple | None = None,
                           compute_dtype=torch.bfloat16,
                           prepared: tuple | None = None) -> torch.Tensor:
    """Fused (conv3x3 → BN → ReLU) × 2 → avg+max pool.

    x ``[B, T, M, Cin]`` in ``compute_dtype``; w ``[3, 3, Cin, Cout]``
    HWIO f32; ab ``(a, b)`` from :func:`fold_bn`; ``mel3`` / ``tri`` the
    per-conv tap modes ``(conv1, conv2)`` with the JAX wrapper's default
    and precedence (:func:`tap_modes`); ``tc`` the chunk (the mode's JAX
    pick if None); ``prepared``, if given, is :func:`kernel_weights` of
    the same weights, kept by the caller so that a forward does not lay
    them out again.  Returns ``[B, T // pt, M // pm, Cout]``, bf16 for
    int8, else in ``compute_dtype``.  On the card ``compute_dtype`` is
    bf16; a mel3 or tri block runs the wgmma slab form where
    :func:`tri_route` says it takes the conv, else direct9's per-tap GEMM
    at the mode's chunk (at M 2 or 4 with time pairs the first slab
    design), as :func:`slab_plan` says.  Serving only (running BN
    statistics).
    """
    b, t, m, cin = x.shape
    cout = w1.shape[-1]
    pt, pm = pool
    modes = tap_modes(cin, quantize, mel3, tri)
    mel3_2 = modes[1]
    tc = tc or block_tc(x.shape, cout, pool, quantize, modes, compute_dtype)
    check_block_args(x, w1, ab1, w2, ab2, pool, tc, compute_dtype)
    if not x.is_cuda:
        return block_plain(x, w1, ab1, w2, ab2, pool, quantize=quantize,
                           tc=tc, modes=modes, compute_dtype=compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the kernel computes in bf16 (or int8)")
    if any(modes) and (m % 2 or 64 % m):
        raise ValueError(f"the mel3 / tri kernel takes M dividing 64, "
                         f"even; got M={m}")
    wk = prepared or kernel_weights(w1, ab1, w2, ab2, quantize)
    check_device(x, *wk)
    out = torch.empty(b, t // pt, m // pm, cout, dtype=torch.bfloat16,
                      device=x.device)
    if any(modes):
        design, slab1, slab2, key = slab_plan(modes, quantize, m, pool)
        if design == "v1":
            _launch_slab_v1(x, wk, modes, quantize, tc, pool, out)
        elif design == "mel3_v2":
            _launch_mel3_v2(x, wk, mel3_2, tc, pool, slab1, slab2, out)
        else:
            _launch_tri_v2(x, wk, quantize, tc, pool, slab1, slab2, out)
        launches[key] += 1
        return out
    if not v2_takes(m, pool):
        _launch_v1(x, wk, quantize, tc, pool, out)
        launches["conv_block_v1"] += 1
        return out
    xs, y1, y1q, smax = scratch_v2(b, t, m, cin, cout, tc, quantize,
                                   x.device, per_clip=True)
    name = "ttg_conv_block_v2"
    fn = _build.function("conv_block_v2", name, _V2_ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, cin, cout, tc, pt,
             pm, *(v.data_ptr() for v in wk), xs.data_ptr(),
             y1.data_ptr(), y1q.data_ptr(), smax.data_ptr(),
             out.data_ptr(), _build.stream())
    launches["conv_block"] += 1
    _build.check(err, name)
    return out


def _launch_slab_v1(x, wk, modes, quantize: bool, tc: int, pool,
                    out) -> None:
    """The mel3 / tri slab kernel (``csrc/conv_block_mel3.cu``): the first
    design of both."""
    b, t, m, cin = x.shape
    cout = out.shape[-1]
    mel3_1, mel3_2, tri_1, tri_2 = modes
    bufs = (*(v.data_ptr() for v in wk),
            *(v.data_ptr() for v in scratch(
                b, t, m, cin, cout, tc, quantize, x.device,
                y1_half=quantize and mel3_2)),
            out.data_ptr(), _build.stream())
    fn = _build.function("conv_block_mel3", "ttg_conv_block_mel3",
                         _SLAB_ARGS)
    err = fn(int(quantize), int(mel3_1), int(tri_1),
             int(mel3_2 or tri_2), int(quantize and mel3_2), x.data_ptr(),
             b, t, m, cin, cout, tc, *pool, *bufs)
    _build.check(err, "ttg_conv_block_mel3")


def _launch_tri_v2(x, wk, quantize: bool, tc: int, pool, slab1: bool,
                   slab2: bool, out) -> None:
    """tri's second design: direct9's pipeline at tri's chunk with conv1 /
    conv2 in the wgmma GEMM's slab form (``csrc/conv_block_tri_v2.cu``)."""
    b, t, m, cin = x.shape
    cout = out.shape[-1]
    check_tri_slab(m, pool, slab1, slab2)
    check_v2_pool(m, pool)
    xs, y1, y1q, smax = scratch_v2(b, t, m, cin, cout, tc, quantize,
                                   x.device, per_clip=True)
    fn = _build.function("conv_block_tri_v2", "ttg_conv_block_tri_v2",
                         _TRI_ARGS)
    err = fn(int(quantize), int(slab1), int(slab2), x.data_ptr(), b, t, m,
             cin, cout, tc, *pool, *(v.data_ptr() for v in wk),
             xs.data_ptr(), y1.data_ptr(), y1q.data_ptr(), smax.data_ptr(),
             out.data_ptr(), _build.stream())
    _build.check(err, "ttg_conv_block_tri_v2")


def _launch_mel3_v2(x, wk, y1_half: bool, tc: int, pool, slab1: bool,
                    slab2: bool, out) -> None:
    """mel3's int8 second design: direct9's pipeline at mel3's chunk with
    mel3's x window and, with ``y1_half``, conv1 rows stored in bf16
    before their scale, conv1 / conv2 in the wgmma GEMM's slab form
    (``csrc/conv_block_mel3_v2.cu``)."""
    b, t, m, cin = x.shape
    cout = out.shape[-1]
    check_tri_slab(m, pool, slab1, slab2)
    check_v2_pool(m, pool)
    xs, y1, y1q, smax = scratch_v2(b, t, m, cin, cout, tc, True, x.device,
                                   per_clip=False, y1_half=y1_half)
    fn = _build.function("conv_block_mel3_v2", "ttg_conv_block_mel3_v2",
                         _TRI_ARGS)
    err = fn(int(slab1), int(slab2), int(y1_half), x.data_ptr(), b, t, m,
             cin, cout, tc, *pool, *(v.data_ptr() for v in wk),
             xs.data_ptr(), y1.data_ptr(), y1q.data_ptr(), smax.data_ptr(),
             out.data_ptr(), _build.stream())
    _build.check(err, "ttg_conv_block_mel3_v2")


def _fused_mel3_v1(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                   w2: torch.Tensor, ab2: tuple, pool: tuple = (1, 2), *,
                   quantize: bool = False, mel3: tuple = (True, True),
                   tc: int | None = None,
                   prepared: tuple | None = None) -> torch.Tensor:
    """mel3's first design (the slab kernel of ``csrc/conv_block_mel3.cu``)
    on a CUDA tensor, arguments as :func:`fused_double_conv_pool`;
    nothing served calls it.  ``chip_smoke.py`` holds the second design
    to it."""
    return _fused_slab_v1(x, w1, ab1, w2, ab2, pool, quantize, tc, prepared,
                          tap_modes(x.shape[3], quantize, mel3, None),
                          "conv_block_mel3_v1")


def _fused_tri_v1(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                  w2: torch.Tensor, ab2: tuple, pool: tuple = (1, 2), *,
                  quantize: bool = False, tri: tuple = (True, True),
                  tc: int | None = None,
                  prepared: tuple | None = None) -> torch.Tensor:
    """tri's first design (the slab kernel of ``csrc/conv_block_mel3.cu``)
    on a CUDA tensor, arguments as :func:`fused_double_conv_pool`;
    nothing served calls it.  ``chip_smoke.py`` holds the second design
    to it."""
    return _fused_slab_v1(x, w1, ab1, w2, ab2, pool, quantize, tc, prepared,
                          tap_modes(x.shape[3], quantize, None, tri),
                          "conv_block_tri_v1")


def _fused_slab_v1(x, w1, ab1, w2, ab2, pool, quantize: bool, tc, prepared,
                   modes: tuple, key: str) -> torch.Tensor:
    """The first slab design on a CUDA tensor for tap ``modes`` with a mel3
    or tri conv, counted in ``launches[key]``."""
    b, t, m, _ = x.shape
    cout = w1.shape[-1]
    tc = tc or block_tc(x.shape, cout, pool, quantize, modes)
    check_block_args(x, w1, ab1, w2, ab2, pool, tc)
    if not x.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    if not any(modes) or m % 2 or 64 % m:
        raise ValueError("the first slab design takes a mel3 or tri conv "
                         "and M dividing 64, even")
    wk = prepared or kernel_weights(w1, ab1, w2, ab2, quantize)
    check_device(x, *wk)
    out = torch.empty(b, t // pool[0], m // pool[1], cout,
                      dtype=torch.bfloat16, device=x.device)
    _launch_slab_v1(x, wk, modes, quantize, tc, pool, out)
    launches[key] += 1
    return out


def _fused_double_conv_pool_v1(x: torch.Tensor, w1: torch.Tensor,
                               ab1: tuple, w2: torch.Tensor, ab2: tuple,
                               pool: tuple = (2, 2), *,
                               quantize: bool = False,
                               tc: int | None = None,
                               prepared: tuple | None = None
                               ) -> torch.Tensor:
    """The first design of direct9 (``csrc/conv_block.cu``) on a CUDA
    tensor, arguments as :func:`fused_double_conv_pool`; nothing served
    calls it.  ``chip_smoke.py`` holds the second design to it."""
    b, t, m, _ = x.shape
    cout = w1.shape[-1]
    tc = tc or block_tc(x.shape, cout, pool, quantize, (False,) * 4)
    check_block_args(x, w1, ab1, w2, ab2, pool, tc)
    if not x.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    wk = prepared or kernel_weights(w1, ab1, w2, ab2, quantize)
    check_device(x, *wk)
    out = torch.empty(b, t // pool[0], m // pool[1], cout,
                      dtype=torch.bfloat16, device=x.device)
    _launch_v1(x, wk, quantize, tc, pool, out)
    launches["conv_block_v1"] += 1
    return out


def _launch_v1(x, wk, quantize: bool, tc: int, pool, out) -> None:
    """direct9's first design (``csrc/conv_block.cu``) on checked
    arguments; the caller counts it."""
    b, t, m, cin = x.shape
    cout = out.shape[-1]
    fn = _build.function("conv_block", "ttg_conv_block", _ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, cin, cout, tc, *pool,
             *(v.data_ptr() for v in wk),
             *(v.data_ptr() for v in scratch(b, t, m, cin, cout, tc,
                                             quantize, x.device)),
             out.data_ptr(), _build.stream())
    _build.check(err, "ttg_conv_block")
