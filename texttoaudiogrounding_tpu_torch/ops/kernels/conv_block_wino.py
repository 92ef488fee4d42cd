"""Winograd F(2×2, 3×3) PANNs block: ``csrc/conv_block_wino.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/conv_block_wino.py:264
fused_block_wino``: (conv3x3 → BN → ReLU) × 2 → 2×2 avg+max pool, each
conv as 16 pointwise ``[tiles, Cin] @ [Cin, Cout]`` products over 2×2
output tiles, ``y = Aᵀ [(G w Gᵀ) ⊙ (Bᵀ d B)] A``.  The JAX package
routes a block here under ``TTG_WINO=1`` (``ConvBlock(wino=True)`` in the
port).

What the kernel computes, as the TPU kernel computes it:

* weights ``U_k = G w Gᵀ`` in f32 (``:73``); in int8 one scale per (k,
  Cout), ``max(max|U_k|, 1e-8) / 127``, the weights multiplied by its
  reciprocal (``:304-309``);
* the input transform ``V_k = Bᵀ d B`` of 16 stride-2 slices in f32, in
  the butterfly's order of additions (``:99``), with zeros outside the
  mel axis and the clip (``:162-176``); conv1's tiles cover times ``[t0 -
  2, t0 + tc + 2)`` of chunk ``t0 = j tc``, a one-tile halo each side;
* int8: ``V_k`` quantized per k and per chunk, ``sv = max(max|V_k|,
  1e-6) / 127`` over all the chunk's tiles, halo tiles included
  (``:184-200``); the product ``(float) Σ q u · (sv · su_k)``; bf16: ``V_k``
  rounded to bf16, f32 sums;
* the output transform in two stages (``:203-210``), BN and ReLU; conv1's
  rows outside ``[0, T)`` zeroed and stored in ``compute_dtype`` (bf16),
  conv2's ``V_k`` built from those rounded rows (``:239-259``); conv2's BN
  and ReLU, then the pool as ``(z00 + z01 + z10 + z11) · 0.25 + max``;
* the chunk ``tc`` and the padded length ``tpad`` as ``_pick_tpad_tc``
  (``:373``) picks them from the TPU's VMEM estimate (``:352``), so the
  int8 result is JAX's; T is zero-padded to ``tpad`` and the output cut
  to ``T // 2``.

The TPU kernel keeps y1 as four parity planes and builds conv2's slices
by static offsets; the card keeps y1 as chunk rows ``[G, tc + 4, M,
Cout]`` in device memory.  In the second design (``csrc/
conv_block_wino_v2.cu``) each conv is a scale pass (int8), one pass
writing V_k once, and one ``wgmma`` kernel running the 16 products and
folding each M_k into the output tile as it finishes, in the plain
version's order of f32 additions (:func:`wino_fold_emulated`), so no M_k
reaches device memory.  The first design (``csrc/conv_block_wino.cu``:
a transform launch, 16 products on ``common.cuh``'s tensor-core tile
with M_k written in f32, an output-transform launch) gives the same int8
result and is reachable only through :func:`_fused_block_wino_v1`.

:func:`fused_block_wino` launches the kernels for a CUDA tensor and runs
:func:`block_wino_plain`, the same arithmetic in plain PyTorch, for a CPU
tensor; :func:`block_wino_emulated` repeats the second design's blocking
on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.kernels import _build
from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
    _pick_tc,
    _quant_i8,
    check_device,
    over127,
)

__all__ = ["fused_block_wino", "block_wino_plain", "transform_weights",
           "winograd_conv3x3", "wino_weights"]

launches = 0          # kernel launches through fused_block_wino
launches_v1 = 0       # the first design's, through _fused_block_wino_v1
FOLD_BM = 128                # output rows of a product-kernel block
SCALE_PIECE = 256            # tiles x 8 channels a max-pass block reads

# F(2x2, 3x3) transform matrices (Lavin & Gray, arXiv:1509.09308)
_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_G = ((1, 0, 0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0, 0, 1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))


def _mat(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=like.device)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """``[3, 3, Cin, Cout]`` HWIO → ``U = G w Gᵀ`` ``[16, Cin, Cout]``
    (k = 4 i + j), in f32."""
    g = _mat(_G, w)
    u = torch.einsum("ax,by,xyio->abio", g, g, w.float())
    return u.reshape(16, w.shape[2], w.shape[3])


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference Winograd conv (SAME zero padding, ``[B, T, M, C]``, T and
    M even), in f32: the math the kernel's blocking rests on."""
    b, t, m, cin = x.shape
    cout = w.shape[3]
    u = transform_weights(w).reshape(4, 4, cin, cout)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    d = torch.stack([torch.stack([xp[:, i:i + t:2, j:j + m:2]
                                  for j in range(4)]) for i in range(4)])
    bt, at = _mat(_BT, x), _mat(_AT, x)
    v = torch.einsum("ix,jy,xybtmc->ijbtmc", bt, bt, d)
    mm = torch.einsum("ijbtmc,ijco->ijbtmo", v, u)
    y = torch.einsum("pi,qj,ijbtmo->btpmqo", at, at, mm)
    return y.reshape(b, t, m, cout)


def butterfly(d: list) -> list:
    """``V = Bᵀ d B`` over a 4×4 list of lists, in the TPU kernel's order
    of additions (``conv_block_wino.py:99``)."""
    s = [[None] * 4 for _ in range(4)]
    for j in range(4):
        s[0][j] = d[0][j] - d[2][j]
        s[1][j] = d[1][j] + d[2][j]
        s[2][j] = d[2][j] - d[1][j]
        s[3][j] = d[1][j] - d[3][j]
    v = [[None] * 4 for _ in range(4)]
    for i in range(4):
        v[i][0] = s[i][0] - s[i][2]
        v[i][1] = s[i][1] + s[i][2]
        v[i][2] = s[i][2] - s[i][1]
        v[i][3] = s[i][1] - s[i][3]
    return v


def _wino_vmem_bytes(tc, tpad, m, cin, cout, quantize, compute_dtype):
    """The TPU kernel's per-chunk VMEM estimate (``:352``)."""
    mp = m // 2
    rows1 = (tc // 2 + 2) * mp
    rows2 = (tc // 2) * mp
    isize = compute_dtype.itemsize
    wsize = 1 if quantize else isize
    return (16 * (cin + cout) * cout * wsize
            + 32 * rows1 * cin * 4
            + 32 * rows2 * cout * 4
            + 4 * (rows1 + 2) * cout * isize
            + ((tpad + 8) * m + 8) * cin * isize
            + ((tc + 8) * m + 8) * cin * isize
            + 2 * rows2 * cout * 2)


def pick_tpad_tc(t, m, cin=128, cout=128, quantize=True,
                 compute_dtype=torch.bfloat16,
                 vmem_budget: int = 13 * 2**20) -> tuple:
    """The JAX package's chunk rule (``:373 _pick_tpad_tc``): the smallest
    zero-padded T (even, then multiples of 8 / 16 / 32 / 64) with an even
    chunk dividing it whose estimated working set fits the budget and
    whose pooled block is a multiple of 8 rows; the largest such chunk.
    Raises where JAX raises (bf16 block 4, say)."""
    mp = m // 2

    def pick(tpad):
        best = 0
        for c in range(2, tpad + 1, 2):
            if tpad % c:
                continue
            if (c // 2 * mp) % 8 and c != tpad:
                continue
            if _wino_vmem_bytes(c, tpad, m, cin, cout, quantize,
                                compute_dtype) > vmem_budget:
                continue
            best = c
        return best

    for mult in (2, 8, 16, 32, 64):
        tpad = -(-t // mult) * mult
        c = pick(tpad)
        if c:
            return tpad, c
    raise ValueError(f"no valid wino chunking for T={t} m={m} "
                     f"cin={cin} cout={cout}")


def routes(shape, cout: int, pool, quantize: bool,
           compute_dtype=torch.bfloat16) -> bool:
    """The JAX ``ConvBlock``'s gate to this kernel under ``TTG_WINO=1``
    (``models/layers.py:191-245``): Cin ≥ 128, pool (2, 2), M even, and a
    chunking both the direct9 kernel and this one accept."""
    _, t, m, cin = shape
    if cin < 128 or tuple(pool) != (2, 2) or m % 2:
        return False
    try:
        _pick_tc(t, m, cin, cout, 2, 2, quantize, compute_dtype)
        pick_tpad_tc(t, m, cin, cout, quantize, compute_dtype)
    except ValueError:
        return False
    return True


def wino_weights(w1, ab1, w2, ab2, quantize: bool,
                 compute_dtype=torch.bfloat16) -> tuple:
    """(u1 [16, Cout, Cin], su1 [16, Cout], a1, b1, u2, su2, a2, b2): the
    transformed weights in the kernel's layout, int8 with their per-(k,
    Cout) scales (``:304-309``) or in ``compute_dtype`` with unit scales;
    BN affines f32."""
    out = []
    for w, (a, b) in ((w1, ab1), (w2, ab2)):
        u = transform_weights(w)
        if quantize:
            su = over127(torch.clamp(u.abs().amax(dim=1), min=1e-8))
            uq = _quant_i8(u, (1.0 / su)[:, None])
        else:
            su = torch.ones(16, u.shape[2], device=u.device)
            uq = u.to(compute_dtype)
        out += [uq.transpose(1, 2).contiguous(), su.contiguous(),
                a.float().contiguous(), b.float().contiguous()]
    return tuple(out)


def _products(v: list, u: torch.Tensor, su: torch.Tensor, quantize: bool,
              compute_dtype) -> list:
    """The 16 products ``M_k = V_k U_k`` of ``[G, R, C]`` slices: int8 per
    (group, k) scales summed exactly, or ``compute_dtype`` operands with f32
    sums."""
    mm = [[None] * 4 for _ in range(4)]
    for k in range(16):
        vk = v[k // 4][k % 4]
        uk = u[k].transpose(0, 1)                       # [Cin, Cout]
        if quantize:
            sv = over127(torch.clamp(vk.abs().amax(dim=(1, 2, 3)),
                                     min=1e-6))
            q = _quant_i8(vk, (1.0 / sv)[:, None, None, None])
            acc = torch.matmul(q.double(), uk.double()).float()
            mk = acc * (sv[:, None, None, None] * su[k])
        else:
            mk = torch.matmul(vk.to(compute_dtype).float(), uk.float())
        mm[k // 4][k % 4] = mk
    return mm


def _output_transform(mm: list) -> list:
    """``Y = Aᵀ M A`` in the TPU kernel's two stages (``:203-210``):
    ``Y[tau][mu]``."""
    s0 = [mm[0][j] + mm[1][j] + mm[2][j] for j in range(4)]
    s1 = [mm[1][j] - mm[2][j] - mm[3][j] for j in range(4)]
    return [[sp[0] + sp[1] + sp[2], sp[1] - sp[2] - sp[3]]
            for sp in (s0, s1)]


def block_wino_plain(x, w1, ab1, w2, ab2, *, quantize: bool, tc: int,
                     tpad: int, compute_dtype=torch.bfloat16,
                     prepared: tuple | None = None,
                     conv=None) -> torch.Tensor:
    """The Winograd block's arithmetic in plain PyTorch, chunk by chunk.
    x ``[B, T, M, Cin]`` → ``[B, T // 2, M // 2, Cout]`` (bf16 for int8,
    else ``compute_dtype``).  ``conv(v, u, su)``, if given, replaces the
    products and the output transform of ``V_k`` planes ``v`` (an
    emulated kernel blocking)."""
    if conv is None:
        def conv(v, u, su):
            return _output_transform(_products(v, u, su, quantize,
                                               compute_dtype))
    b, t, m, _ = x.shape
    mp, nch, nt = m // 2, tpad // tc, tc // 2 + 2
    g = b * nch
    u1, su1, a1, b1, u2, su2, a2, b2 = prepared or wino_weights(
        w1, ab1, w2, ab2, quantize, compute_dtype)
    # conv1: chunk j reads times [j tc - 3, j tc + tc + 3), mels -1 .. M
    xf = x.to(compute_dtype).float()
    xp = F.pad(xf, (0, 0, 1, 1, 3, tpad - t + 3))
    win = xp.unfold(1, tc + 6, tc).permute(0, 1, 4, 2, 3).reshape(
        g, tc + 6, m + 2, -1)
    d = [[win[:, i:i + 2 * nt - 1:2, j:j + 2 * mp - 1:2]
          for j in range(4)] for i in range(4)]
    y = conv(butterfly(d), u1, su1)
    rows = (torch.arange(nch, device=x.device)[:, None] * tc - 2
            + torch.arange(2 * nt, device=x.device)[None])
    valid = ((rows >= 0) & (rows < t)).repeat(b, 1)       # [G, tc + 4]
    planes = torch.stack([torch.stack(
        [torch.relu(y[tau][mu] * a1 + b1) for mu in range(2)], 3)
        for tau in range(2)], 2)                  # [G, nt, 2, mp, 2, C]
    y1 = planes.reshape(g, 2 * nt, m, -1)
    y1 = torch.where(valid[:, :, None, None], y1, 0.0).to(compute_dtype)
    # conv2: tile (u, b) of chunk j reads y1 rows 2 u + i + 1, mels 2 b + j - 1
    yp = F.pad(y1.float(), (0, 0, 1, 1))
    d = [[yp[:, i + 1:i + tc:2, j:j + 2 * mp - 1:2] for j in range(4)]
         for i in range(4)]
    z = conv(butterfly(d), u2, su2)
    z = [[torch.relu(z[tau][mu] * a2 + b2) for mu in range(2)]
         for tau in range(2)]
    s = z[0][0] + z[0][1] + z[1][0] + z[1][1]
    mx = torch.maximum(torch.maximum(z[0][0], z[0][1]),
                       torch.maximum(z[1][0], z[1][1]))
    out = (s * 0.25 + mx).reshape(b, tpad // 2, mp, -1)[:, :t // 2]
    return out.to(torch.bfloat16 if quantize else compute_dtype)


def wino_fold_emulated(mm: list) -> list:
    """The product kernel's fold of the 16 ``M_k`` (``mm[k]``, k = 4 i +
    j) as each finishes, j outer, i inner: ``s0 = (m0j + m1j) + m2j``,
    ``s1 = (m1j - m2j) - m3j``, then ``y_t0 = s_t0 (j = 0) + s_t1 + s_t2``,
    ``y_t1 = s_t1 (j = 1) - s_t2 - s_t3``: :func:`_output_transform`'s
    additions in its order, so the same bits.  → ``Y[tau][mu]``."""
    y = [[None, None], [None, None]]
    for j in range(4):
        for i in range(4):
            mk = mm[4 * i + j]
            if i == 0:
                s0 = mk
            elif i == 1:
                s0, s1 = s0 + mk, mk
            elif i == 2:
                s0, s1 = s0 + mk, s1 - mk
            else:
                s1 = s1 - mk
        for tau, st in enumerate((s0, s1)):
            if j == 0:
                y[tau][0] = st
            elif j == 1:
                y[tau][0], y[tau][1] = y[tau][0] + st, st
            elif j == 2:
                y[tau][0], y[tau][1] = y[tau][0] + st, y[tau][1] - st
            else:
                y[tau][1] = y[tau][1] - st
    return y


def wino_scales_emulated(vk: torch.Tensor,
                         piece: int = SCALE_PIECE) -> torch.Tensor:
    """``wino_max_kernel``: max |V_k| of ``vk [16, G, R, C]`` per (k,
    group), each block taking ``piece`` consecutive (tile, 8-channel)
    items of one group and the blocks' maxes combined by max (the
    kernel's ``atomicMax``), → ``[16, G]`` before the 1e-6 floor."""
    k, g, r, c = vk.shape
    items = vk.abs().reshape(k, g, r * c // 8, 8).amax(-1)
    out = torch.zeros(k, g)
    for a0 in range(0, items.shape[2], piece):
        out = torch.maximum(out, items[:, :, a0:a0 + piece].amax(-1))
    return out


def _fold_conv_emulated(v, u, su, quantize: bool, compute_dtype,
                        piece: int):
    """One conv of the second design: the scales by pieces, V_k quantized
    (or rounded) once, then per 128-tile block, tiles crossing group edges,
    the products a 64-byte K chunk at a time (exact int sums; f32 for
    bf16) in the walk's order, each ``M_k`` scaled by its rows' own group
    scale and folded by :func:`wino_fold_emulated`."""
    vk = torch.stack([v[k // 4][k % 4] for k in range(16)])
    _, g, nt, mp, c = vk.shape
    r, cout = nt * mp, u.shape[1]
    p = g * r
    vk = vk.reshape(16, g, r, c)
    if quantize:
        sv = over127(torch.clamp(wino_scales_emulated(vk, piece), min=1e-6))
        q = _quant_i8(vk, (1.0 / sv)[:, :, None, None]).double()
        acc_t, kb = torch.float64, 64
    else:
        q = vk.to(compute_dtype).float()
        acc_t, kb = torch.float32, 32
    q = q.reshape(16, p, c)
    ud = u.to(acc_t)
    out = torch.empty(4, p, cout)
    for p0 in range(0, p, FOLD_BM):
        rows = torch.arange(p0, p0 + FOLD_BM).clamp(max=p - 1)
        mm = [None] * 16
        for kk in range(16):
            k = 4 * (kk % 4) + kk // 4
            acc = torch.zeros(FOLD_BM, cout, dtype=acc_t)
            for c0 in range(0, c, kb):
                acc = acc + q[k, rows, c0:c0 + kb] @ ud[k, :, c0:c0 + kb].T
            mm[k] = acc.float()
            if quantize:
                mm[k] = mm[k] * (sv[k, rows // r][:, None] * su[k][None])
        y = wino_fold_emulated(mm)
        end = min(p0 + FOLD_BM, p)
        out[:, p0:end] = torch.stack([y[0][0], y[0][1], y[1][0],
                                      y[1][1]])[:, :end - p0]
    out = out.reshape(4, g, nt, mp, cout)
    return [[out[0], out[1]], [out[2], out[3]]]


def block_wino_emulated(x, w1, ab1, w2, ab2, *, quantize: bool, tc: int,
                        tpad: int, compute_dtype=torch.bfloat16,
                        piece: int = SCALE_PIECE) -> torch.Tensor:
    """The second design's block on the CPU: :func:`block_wino_plain` with
    each conv's products and output transform in the product kernel's
    blocking (:func:`_fold_conv_emulated`)."""
    return block_wino_plain(
        x, w1, ab1, w2, ab2, quantize=quantize, tc=tc, tpad=tpad,
        compute_dtype=compute_dtype,
        conv=lambda v, u, su: _fold_conv_emulated(v, u, su, quantize,
                                                  compute_dtype, piece))


def check_kernel_shape(m: int, cin: int, cout: int) -> None:
    """Raise on a shape the kernels do not take: M even, Cin and Cout
    multiples of 64 (whole 64-channel output blocks and 64-byte K
    chunks)."""
    if m % 2 or cin % 64 or cout % 64:
        raise ValueError(f"the Winograd kernels take M even and Cin, Cout "
                         f"multiples of 64; got M={m}, {cin} -> {cout}")


def chunking(t: int, m: int, cin: int, cout: int, quantize: bool,
             tc: int | None, compute_dtype=torch.bfloat16) -> tuple:
    """(tpad, tc): JAX's pick, or for a given tc, T padded to even
    (``:293-295``); tc must be even and divide tpad."""
    if tc is None:
        return pick_tpad_tc(t, m, cin, cout, quantize, compute_dtype)
    tpad = t + t % 2
    if tc <= 0 or tc % 2 or tpad % tc:
        raise ValueError(f"tc={tc} must be even and divide {tpad}")
    return tpad, tc


_P, _I = _build.P, _build.I
_ARGS = [_I, _P, _I, _I, _I, _I, _I, _I, _I] + [_P] * 14
_V2_ARGS = _ARGS[:17] + [_P] * 5


def _args(x, w1, ab1, w2, ab2, quantize, tc, compute_dtype):
    """Validated (b, t, m, cin, cout, tpad, tc)."""
    if x.dim() != 4 or x.shape[2] % 2:
        raise ValueError("x must be [B, T, M, Cin] with M even")
    b, t, m, cin = x.shape
    cout = w1.shape[-1]
    if tuple(w1.shape) != (3, 3, cin, cout) or \
            tuple(w2.shape) != (3, 3, cout, cout):
        raise ValueError("weights must be HWIO [3, 3, Cin, Cout]")
    check_device(x, w1, w2, *ab1, *ab2)
    tpad, tc = chunking(t, m, cin, cout, quantize, tc, compute_dtype)
    return b, t, m, cin, cout, tpad, tc


def _kernel_inputs(x, w1, ab1, w2, ab2, quantize, compute_dtype, prepared):
    """The card's checks; the weights in the kernels' layout."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or compute_dtype != torch.bfloat16:
        raise ValueError("the kernel takes contiguous bf16 x and computes "
                         "in bf16")
    check_kernel_shape(x.shape[2], x.shape[3], w1.shape[-1])
    wk = prepared or wino_weights(w1, ab1, w2, ab2, quantize)
    check_device(x, *wk)
    return wk


def fused_block_wino(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                     w2: torch.Tensor, ab2: tuple, *,
                     quantize: bool = False, tc: int | None = None,
                     compute_dtype=torch.bfloat16,
                     prepared: tuple | None = None) -> torch.Tensor:
    """Whole PANNs block by Winograd F(2×2, 3×3).

    x ``[B, T, M, Cin]`` (M even); w ``[3, 3, Cin, Cout]`` HWIO f32; ab
    ``(a, b)`` folded BN affines; ``tc`` the chunk (JAX's pick if None);
    ``prepared``, if given, is :func:`wino_weights` of the same weights.
    Returns ``[B, T // 2, M // 2, Cout]``, bf16 when quantized, else in
    ``compute_dtype``.  On the card x is bf16 and ``compute_dtype`` bf16,
    Cin and Cout multiples of 64; it runs the second design.  Serving only
    (running BN statistics).
    """
    global launches
    b, t, m, cin, cout, tpad, tc = _args(x, w1, ab1, w2, ab2, quantize, tc,
                                         compute_dtype)
    if not x.is_cuda:
        return block_wino_plain(x, w1, ab1, w2, ab2, quantize=quantize,
                                tc=tc, tpad=tpad,
                                compute_dtype=compute_dtype,
                                prepared=prepared)
    wk = _kernel_inputs(x, w1, ab1, w2, ab2, quantize, compute_dtype,
                        prepared)
    g, mp = b * (tpad // tc), m // 2
    r1, r2 = (tc // 2 + 2) * mp, tc // 2 * mp
    dev = x.device
    act = torch.int8 if quantize else torch.bfloat16
    v = torch.empty(16 * g * max(r1 * cin, r2 * cout), dtype=act, device=dev)
    svbits = torch.empty(2, 16, g, dtype=torch.int32, device=dev)
    y1 = torch.empty(g, tc + 4, m, cout, dtype=torch.bfloat16, device=dev)
    out = torch.empty(b, t // 2, mp, cout, dtype=torch.bfloat16, device=dev)
    fn = _build.function("conv_block_wino_v2", "ttg_conv_block_wino_v2",
                         _V2_ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, cin, cout, tc, tpad,
             *(w.data_ptr() for w in wk), v.data_ptr(), svbits.data_ptr(),
             y1.data_ptr(), out.data_ptr(), _build.stream())
    _build.check(err, "ttg_conv_block_wino_v2")
    launches += 1
    return out


def _fused_block_wino_v1(x: torch.Tensor, w1: torch.Tensor, ab1: tuple,
                         w2: torch.Tensor, ab2: tuple, *,
                         quantize: bool = False, tc: int | None = None,
                         prepared: tuple | None = None) -> torch.Tensor:
    """The first design (``csrc/conv_block_wino.cu``) on a CUDA tensor,
    arguments as :func:`fused_block_wino`; nothing served calls it.
    ``chip_smoke.py`` holds the second design to it."""
    global launches_v1
    b, t, m, cin, cout, tpad, tc = _args(x, w1, ab1, w2, ab2, quantize, tc,
                                         torch.bfloat16)
    if not x.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    wk = _kernel_inputs(x, w1, ab1, w2, ab2, quantize, torch.bfloat16,
                        prepared)
    g, mp = b * (tpad // tc), m // 2
    r1, r2 = (tc // 2 + 2) * mp, tc // 2 * mp
    dev = x.device
    act = torch.int8 if quantize else torch.bfloat16
    v = torch.empty(16 * g * max(r1 * cin, r2 * cout), dtype=act, device=dev)
    sv = torch.empty(2, 16, g, device=dev)
    mbuf = torch.empty(16 * g * r1 * cout, device=dev)
    y1 = torch.empty(g, tc + 4, m, cout, dtype=torch.bfloat16, device=dev)
    out = torch.empty(b, t // 2, mp, cout, dtype=torch.bfloat16, device=dev)
    fn = _build.function("conv_block_wino", "ttg_conv_block_wino", _ARGS)
    err = fn(int(quantize), x.data_ptr(), b, t, m, cin, cout, tc, tpad,
             *(w.data_ptr() for w in wk), v.data_ptr(), sv.data_ptr(),
             mbuf.data_ptr(), y1.data_ptr(), out.data_ptr(), _build.stream())
    _build.check(err, "ttg_conv_block_wino")
    launches_v1 += 1
    return out
