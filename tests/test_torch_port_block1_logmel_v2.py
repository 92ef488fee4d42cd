"""The second designs of rows 2 (``csrc/conv_block1_v2.cu``) and 1
(``csrc/logmel_v2.cu``), emulated on the CPU in their own blocking.

The card's kernels cannot run here, so this file repeats their blocking in
PyTorch and holds the result to the plain versions and to the JAX kernels
(``interpret=True``).

Row 2, block 1:

* the clip's x scale from maxes of pieces of the clip combined by max
  (``window_max_kernel``), turned into the first design's bf16 scale;
* conv1 by blocks of ``TT`` rows of one group, the int8 taps of a cell
  packed into three words from row words (``__byte_perm``) and summed per
  channel by three ``dp4a``; the bf16 mode's f32 ``fmaf`` chain;
* y1 in the mel-padded layout ``[G, R, 66, 64]``: under ``"conv1"`` /
  ``False`` bf16 rows at times ``[-1, 2 (T // 2)]``; under ``True`` a max
  pass over the chunk's scale window (halo 1 or 2) by blocks, then the
  ``tc + 2`` rows conv2 reads, int8;
* conv2 as the implicit GEMM of ``tests/test_torch_port_conv_igemm.py``
  (tiles of 128 rows, the time-pair row permutation) and block 1's bf16
  pool from inside one tile (y2 to bf16, time pairs, then mel pairs);
* ``"conv1"`` mode's fused form (``b1_fused_kernel``): per tile of one
  time pair, y1's four bf16 halo rows in three shared-memory copies in the
  no-swizzle core-matrix layout, each tap's A and the weights read through
  their wgmma descriptors (start, LBO, SBO), and the pool over lanes l ^ 4
  (time pair) and l ^ 8 (mel pair).

Row 1, log-mel: the wide pad pass, the interleaved basis and its four
passes of 128 bins over 128-frame tiles, power from a (re, im) column pair,
and the band-limited mel sum, which equals the full ascending f32
projection bit for bit.

Tolerances: int8 bit for bit against the plain version, and conv1's bf16
y1 bit for bit in ``"conv1"`` mode; against the JAX kernel relative RMS
5e-3 (``"conv1"``, ``True``) and 1e-2 (``False``) as in
``tests/test_torch_port_kernels.py``; bf16 1e-2 against the plain version;
the log-mel within 2e-3 dB of the plain version and of the JAX kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_port_conv_igemm import BM, igemm, tile_perm
from texttoaudiogrounding_tpu.ops import frontend as jfront
from texttoaudiogrounding_tpu.ops.pallas import conv_block1_pair as jb1
from texttoaudiogrounding_tpu.ops.pallas import logmel as jlm
from texttoaudiogrounding_tpu_torch.ops import frontend as tfront
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair as tb1
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel as tlm

TT = 16           # conv1 rows of a block (b1_conv1_kernel)
PIECE = 512       # elements of a window_max_kernel piece (8192 on the card)
MELS = 64


def _bf(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def _rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _np(out):
    return out.float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)


def _case(t, seed, loud=None, clips=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(clips, t, MELS)).astype(np.float32)
    if loud is not None:
        x *= 0.05
        x[:, loud] = 5.0
    w1 = (rng.normal(size=(3, 3, 1, 64)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(np.float32)
    ab = [(rng.uniform(0.5, 1.5, 64).astype(np.float32),
           (rng.normal(size=64) * 0.1).astype(np.float32))
          for _ in range(2)]
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    targs = (tx, torch.from_numpy(w1), tuple(map(torch.from_numpy, ab[0])),
             torch.from_numpy(w2), tuple(map(torch.from_numpy, ab[1])))
    jargs = (jx, jnp.asarray(w1), tuple(map(jnp.asarray, ab[0])),
             jnp.asarray(w2), tuple(map(jnp.asarray, ab[1])))
    return targs, jargs


# ------------------------------------------------------- row 2: block 1

def clip_scales(x: torch.Tensor) -> tuple:
    """(sx, inv) of each clip: ``window_max_kernel``'s max over pieces of
    the clip combined by max, then ``bf16(max(m, bf16(1e-6)) / 127)`` and
    its bf16 reciprocal, as ``b1_conv1_kernel`` computes them."""
    flat = x.float().abs().reshape(x.shape[0], -1)
    m = torch.zeros(x.shape[0])
    for a0 in range(0, flat.shape[1], PIECE):
        m = torch.maximum(m, flat[:, a0:a0 + PIECE].amax(dim=1))
    mm = torch.maximum(m, _bf(torch.tensor(1e-6)))
    sx = _bf(mm / torch.full_like(mm, 127.0))
    return sx, _bf(1.0 / sx)


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """``__byte_perm``: result byte n is byte ``sel >> 4n & 7`` of (y:x)."""
    src = (x.astype(np.uint64) | (y.astype(np.uint64) << 32))
    out = np.zeros(x.shape, np.uint64)
    for n in range(4):
        s = (sel >> (4 * n)) & 7
        out |= ((src >> np.uint64(8 * s)) & np.uint64(0xff)) << np.uint64(
            8 * n)
    return out.astype(np.uint32)


def dp4a(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``__dp4a``: the dot product of the signed bytes of a and b, plus c."""
    la = a.astype(np.uint32).view(np.int8).reshape(*a.shape, 4)
    lb = b.astype(np.uint32).view(np.int8).reshape(*b.shape, 4)
    return c + (la.astype(np.int64) * lb.astype(np.int64)).sum(-1)


def pack_w1(wq: torch.Tensor) -> np.ndarray:
    """Each (mel, channel)'s nine int8 taps in three words ``[3, 64, C]``:
    taps 0-3, taps 4-7, tap 8 (the kernel packs them once per thread)."""
    b = wq.numpy().astype(np.uint8).astype(np.uint32)      # [64, 9, C]
    out = np.zeros((3, *b[:, 0].shape), np.uint32)
    for k in range(9):
        out[k // 4] |= b[:, k] << np.uint32(8 * (k % 4))
    return out


def conv1_block(x, b: int, t0: int, rows: int, q: dict | None, wk1, ak1,
                bk1) -> torch.Tensor:
    """One block of ``b1_conv1_kernel``: rows at times ``t0 .. t0 + rows``
    of clip b, ``[rows, 64, C]`` f32 after the ReLU.  The x tile holds
    times ``t0 - 1 ..`` and mels -1 .. 64, zero outside the clip; int8
    (``q`` has the clip's ``inv``, ``sx``) through row words, packed taps
    and dp4a, else the bf16 fmaf chain in tap order."""
    t = x.shape[1]
    tile = torch.zeros(rows + 2, MELS + 2)
    lo, hi = max(t0 - 1, 0), min(t0 + rows + 1, t)
    if lo < hi:
        tile[lo - (t0 - 1):hi - (t0 - 1), 1:-1] = x[b, lo:hi].float()
    if q is not None:
        tq = tcb._quant_i8(tile, q["inv"][b]).numpy().astype(np.uint8)
        tq = tq.astype(np.uint32)
        rw = tq[:, :-2] | (tq[:, 1:-1] << 8) | (tq[:, 2:] << 16)
        p0 = byte_perm(rw[:-2], rw[1:-1], 0x4210)           # taps 0-3
        p1 = byte_perm(rw[1:-1], rw[2:], 0x5421)            # taps 4-7
        p2 = byte_perm(rw[2:], np.zeros_like(rw[2:]), 0x4442)
        wp = q["wp"]                                         # [3, 64, C]
        acc = dp4a(p0[..., None], wp[0][None],
                   dp4a(p1[..., None], wp[1][None],
                        dp4a(p2[..., None], wp[2][None], 0)))
        mul = ak1 * q["sx"][b]                               # [64, C]
        y = torch.from_numpy(acc.astype(np.float32)) * mul
    else:
        w = wk1.float()                                      # [9, C]
        acc = torch.zeros(rows, MELS, w.shape[1])
        for k in range(9):
            xk = tile[k // 3:k // 3 + rows, k % 3:k % 3 + MELS]
            acc = acc + xk[..., None] * w[k]      # exact products: fmaf
        y = acc * ak1
    return torch.relu(y + bk1)


def emulate_block1(x, w1, ab1, w2, ab2, *, quantize, tc=48, mode="triple",
                   info: dict | None = None):
    """The second design's block 1 on ``x [B, T, 64]`` bf16."""
    b, t, _ = x.shape
    wk1, ak1, bk1, wk2, a2, b2 = tb1.kernel_weights(w1, ab1, w2, ab2,
                                                    quantize)
    q = None
    if quantize in ("conv1", True):
        sx, inv = clip_scales(x)
        q = {"sx": sx, "inv": inv, "wp": pack_w1(wk1)}
    if quantize is True:
        halo = tb1.HALO[mode]
        nch = -(-t // tc)
        g_count, r_out, r_in = b * nch, tc, tc + 2
        ymax = torch.zeros(g_count)
        y1 = torch.zeros(g_count, r_in, MELS + 2, 64, dtype=torch.int8)
        for g in range(g_count):
            bi, j = divmod(g, nch)
            for r0 in range(0, tc + 2 * halo, TT):       # OUT_MAX blocks
                rows = min(TT, tc + 2 * halo - r0)
                y = conv1_block(x, bi, j * tc - halo + r0, rows, q, wk1,
                                ak1, bk1)
                ymax[g] = torch.maximum(ymax[g], y.max())
            sy = tcb.over127(torch.clamp(ymax[g], min=1e-6))
            for r0 in range(0, r_in, TT):                # OUT_Q8 blocks
                rows = min(TT, r_in - r0)
                t0 = j * tc - 1 + r0
                y = conv1_block(x, bi, t0, rows, q, wk1, ak1, bk1)
                yq = tcb._quant_i8(y, 1.0 / sy)
                time = t0 + torch.arange(rows)
                yq[(time < 0) | (time >= t)] = 0
                y1[g, r0:r0 + rows, 1:-1] = yq
        gscale = tcb.over127(torch.clamp(ymax, min=1e-6))
    else:
        nch, tr = 1, t // 2 * 2
        g_count, r_out, r_in = b, tr, tr + 2
        y1 = torch.zeros(b, r_in, MELS + 2, 64, dtype=torch.bfloat16)
        for bi in range(b):
            for r0 in range(0, r_in, TT):
                rows = min(TT, r_in - r0)
                t0 = r0 - 1
                y = conv1_block(x, bi, t0, rows, q, wk1, ak1, bk1)
                time = t0 + torch.arange(rows)
                y[(time < 0) | (time >= t)] = 0.0
                y1[bi, r0:r0 + rows, 1:-1] = y.to(torch.bfloat16)
        gscale = None
    tiles = []
    acc2 = igemm(y1, wk2, r_out, tiles, tile_perm(MELS, True))
    if info is not None:
        info.update(y1=y1, tiles=tiles, rows=(r_in, r_out),
                    ymax=ymax if quantize is True else None)
    return pool_b1(acc2, a2, b2, gscale, b, nch, r_out, t, tiles)


def pool_b1(acc, alpha, beta, gscale, b, nch, tc, t, tiles):
    """igemm MODE 3's epilogue: ``bf16(relu(acc (alpha scale) + beta))``,
    each 2 × 2 window inside one tile at fragment rows k, k ^ 1 (lanes l,
    l ^ 4) and k + 8, (k + 8) ^ 1; time pairs summed in bf16, then mel
    pairs, ``bf16(bf16(S / 4) + max)``; rows past the clip dropped."""
    n_pos, cout = acc.shape
    g = torch.arange(n_pos) // (tc * MELS)
    mul = alpha[None] * gscale[g][:, None] if gscale is not None \
        else alpha[None].expand(n_pos, -1)
    y = _bf(torch.relu(acc.float() * mul + beta))
    tile_of = torch.empty(n_pos, dtype=torch.long)
    row_of = torch.empty(n_pos, dtype=torch.long)
    for k, (p0, end, inv) in enumerate(tiles):
        tile_of[p0:end] = k
        row_of[p0:end] = inv[:end - p0]
    out = torch.zeros(b, t // 2, MELS // 2, cout)
    for p in range(n_pos):
        gi, r, mm = p // (tc * MELS), (p // MELS) % tc, p % MELS
        if r % 2 or mm % 2:
            continue
        win = [[p + di * MELS + dj for dj in range(2)] for di in range(2)]
        assert len({int(tile_of[c]) for row in win for c in row}) == 1
        k = int(row_of[p])
        assert [[int(row_of[c]) for c in row] for row in win] == [
            [k + 8 * di + dj for dj in range(2)] for di in range(2)]
        s = [_bf(y[win[0][dj]] + y[win[1][dj]]) for dj in range(2)]
        mx = torch.maximum(torch.maximum(y[win[0][0]], y[win[1][0]]),
                           torch.maximum(y[win[0][1]], y[win[1][1]]))
        big_s = _bf(s[0] + s[1])
        bi, j = divmod(gi, nch)
        tout = (j * tc + r) // 2
        if tout < t // 2:
            out[bi, tout, mm // 2] = _bf(_bf(big_s * 0.25) + mx)
    return out.to(torch.bfloat16)


HCH = 66 * 32     # bytes of one 16-byte channel chunk of a halo copy


FNCH = 8          # 16-byte chunks of a bf16 y1 cell of 64 channels


def fused_halo(rows: torch.Tensor) -> np.ndarray:
    """``b1_fused_kernel``'s halo buffer from bf16 y1 rows ``[4, 64, 64]``
    (times t0 - 1 .. t0 + 2): three copies, copy dt holding times (t0 - 1 +
    dt, t0 + dt), each ``[chunk][mel + 1][time of the pair][16 bytes]``
    with zero pad mels."""
    cells = rows.contiguous().view(torch.uint8).numpy()     # [4, 64, 128]
    nch = FNCH
    buf = np.zeros(3 * nch * HCH, np.uint8)
    for h in range(4):
        for dt in (h - 1, h):
            if not 0 <= dt <= 2:
                continue
            for c in range(nch):
                for m in range(64):
                    at = dt * nch * HCH + c * HCH + (m + 1) * 32 + (h - dt) * 16
                    buf[at:at + 16] = cells[h, m, 16 * c:16 * c + 16]
    return buf


def desc_read(buf: np.ndarray, start: int, lbo: int, sbo: int) -> np.ndarray:
    """The 64 rows x 32 bytes that a no-swizzle K-major wgmma descriptor
    (start, LBO, SBO) addresses: row r = 8 g + i at start + g SBO + 16 i,
    its two 16-byte K chunks LBO apart."""
    out = np.empty((64, 32), np.uint8)
    for r in range(64):
        g, i = divmod(r, 8)
        for c in range(2):
            at = start + g * sbo + 16 * i + c * lbo
            out[r, 16 * c:16 * c + 16] = buf[at:at + 16]
    return out


def fused_tile_sums(rows: torch.Tensor, wk2: torch.Tensor) -> torch.Tensor:
    """conv2's sums of one fused tile, ``[128, 64]``: for each warpgroup,
    tap and k step, A and B read through their descriptors (A at copy dt,
    dm mels on, LBO one chunk, SBO 4 mels; B ``[chunk][n][16 bytes]``, LBO
    1024, SBO 128), multiplied as the wgmma does (f32 sums of exact
    products, here in f64 and rounded once)."""
    halo = fused_halo(rows)
    cpy = FNCH * HCH
    wb = wk2.contiguous().view(torch.uint8).numpy()          # [64, 9 nch 16]
    bs = wb.reshape(64, 9 * FNCH, 16).transpose(1, 0, 2).reshape(-1)
    acc = torch.zeros(128, 64, dtype=torch.float64)

    def values(b):
        v = b.copy().view(np.uint16).astype(np.int16)
        return torch.from_numpy(v).view(torch.bfloat16).double()

    for wg in range(2):
        for tap in range(9):
            dt, dm = divmod(tap, 3)
            for kk in range(FNCH // 2):
                a = desc_read(halo, wg * 1024 + dt * cpy + 2 * kk * HCH
                              + dm * 32, HCH, 128)
                b = desc_read(bs, (tap * FNCH + 2 * kk) * 1024, 1024, 128)
                acc[64 * wg:64 * wg + 64] += values(a) @ values(b).T
    return acc.float().double()


def fused_row(k: int) -> tuple:
    """(mel, time of the pair) of accumulator row k of a fused tile."""
    wg, r = divmod(k, 64)
    g, i = divmod(r, 8)
    return 32 * wg + 4 * g + i // 2, i % 2


def fused_halo_rows(x, q: dict, wk, b: int, t0: int) -> torch.Tensor:
    """The fused tile's bf16 y1 rows at times t0 - 1 .. t0 + 2 of clip b
    (``[4, 64, 64]``), by the same dp4a conv1, zero outside the clip."""
    y = conv1_block(x, b, t0 - 1, 4, q, *wk)
    time = t0 - 1 + torch.arange(4)
    y[(time < 0) | (time >= x.shape[1])] = 0.0
    return y.to(torch.bfloat16)


def emulate_block1_fused(x, w1, ab1, w2, ab2):
    """``"conv1"`` mode's fused form: per tile of one time pair, y1's
    halo from the dp4a conv1, its sums through the descriptors, and block
    1's pool over the lanes l, l ^ 4 (time pair) and l, l ^ 8 (mel pair)
    of each thread's 8-row group."""
    b, t, _ = x.shape
    wk1, ak1, bk1, wk2, a2, b2 = tb1.kernel_weights(w1, ab1, w2, ab2,
                                                    "conv1")
    sx, inv = clip_scales(x)
    q = {"sx": sx, "inv": inv, "wp": pack_w1(wk1)}
    out = torch.zeros(b, t // 2, 32, 64, dtype=torch.bfloat16)
    for tile in range(b * (t // 2)):
        bi, pair = divmod(tile, t // 2)
        t0 = 2 * pair
        rows = fused_halo_rows(x, q, (wk1, ak1, bk1), bi, t0)
        acc = fused_tile_sums(rows, wk2)
        v = _bf(torch.relu(acc.float() * a2 + b2))            # [128, 64]
        for k in range(128):
            mel, tau = fused_row(k)
            if tau or mel % 2:
                continue
            # lanes l ^ 4 and l ^ 8 hold rows k ^ 1 and k ^ 2
            assert fused_row(k ^ 1) == (mel, 1)
            assert fused_row(k ^ 2) == (mel + 1, 0)
            assert fused_row(k ^ 3) == (mel + 1, 1)
            s0, s1 = _bf(v[k] + v[k ^ 1]), _bf(v[k ^ 2] + v[k ^ 3])
            mx = torch.maximum(torch.maximum(v[k], v[k ^ 1]),
                               torch.maximum(v[k ^ 2], v[k ^ 3]))
            out[bi, t0 // 2, mel // 2] = _bf(_bf(_bf(s0 + s1) * 0.25) + mx)
    return out


def test_row2_fused_halo_descriptors_address_the_taps():
    """Every A row that tap (dt, dm) reads through its descriptor is y1 at
    time t0 + tau + dt - 1 and mel m + dm - 1 (zero at the pad mels)."""
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(4, 64, 64)).astype(
        np.float32)).to(torch.bfloat16)
    cells = rows.view(torch.uint8).numpy()
    halo = fused_halo(rows)
    for wg in range(2):
        for tap in range(9):
            dt, dm = divmod(tap, 3)
            for kk in range(FNCH // 2):
                a = desc_read(halo, wg * 1024 + dt * FNCH * HCH
                              + 2 * kk * HCH + dm * 32, HCH, 128)
                for r in range(64):
                    mel, tau = fused_row(64 * wg + r)
                    src, want = mel + dm - 1, np.zeros(32, np.uint8)
                    if 0 <= src < 64:
                        want = cells[tau + dt, src, 32 * kk:32 * kk + 32]
                    np.testing.assert_array_equal(a[r], want)


@pytest.mark.parametrize("t", [21, 38])
def test_row2_fused_halo_rows_equal_plain_y1(t):
    """Every fused tile's halo holds the plain version's bf16 y1 bit for
    bit at times t0 - 1 .. t0 + 2, zero outside the clip."""
    targs, _ = _case(t, seed=t + 1)
    x, w1, ab1 = targs[:3]
    wk1, ak1, bk1 = tb1.kernel_weights(*targs[1:], "conv1")[:3]
    sx, inv = clip_scales(x)
    q = {"sx": sx, "inv": inv, "wp": pack_w1(wk1)}
    ref = F.pad(plain_conv1_y1(x, w1, ab1), (0, 0, 0, 0, 1, 2))
    for b in range(x.shape[0]):
        for t0 in range(0, t // 2 * 2, 2):
            rows = fused_halo_rows(x, q, (wk1, ak1, bk1), b, t0)
            assert torch.equal(rows, ref[b, t0:t0 + 4])


@pytest.mark.parametrize("t", [21, 38])
def test_row2_fused_conv1_mode_close_to_plain(t):
    targs, _ = _case(t, seed=t)
    got = emulate_block1_fused(*targs)
    ref = tb1.block1_plain(*targs, quantize="conv1")
    assert got.shape == ref.shape
    assert _rel_rms(_np(got), _np(ref)) <= 1e-2


def plain_conv1_y1(x, w1, ab1) -> torch.Tensor:
    """``block1_plain``'s bf16 y1 in ``"conv1"`` mode, ``[B, T, 64, 64]``."""
    sx = tb1.clip_scale(x)
    xq = tcb._quant_i8(x.float(), (1.0 / sx).float()[:, None, None])
    wq, s1 = tb1.conv1_weights(w1)
    mul = (ab1[0].float()[None] * s1)[None] * sx.float()[:, None, None]
    acc = torch.einsum("btmk,mkc->btmc", tb1._taps(xq.double()),
                       wq.double()).float()
    return torch.relu(acc * mul[:, None] + ab1[1].float()).to(torch.bfloat16)


@pytest.mark.parametrize("t,tc,mode", [(37, 16, "triple"), (64, 16, "triple"),
                                       (37, 16, "single"), (50, 32, "single")])
def test_row2_int8_emulation_equals_plain(t, tc, mode):
    targs, _ = _case(t, seed=t + tc)
    got = emulate_block1(*targs, quantize=True, tc=tc, mode=mode)
    ref = tb1.block1_plain(*targs, quantize=True, tc=tc, mode=mode)
    assert got.shape == (2, t // 2, 32, 64) and torch.equal(got, ref)


def test_row2_single_window_sees_its_loud_frame():
    """A loud frame at t = 18 = j tc + tc + 1 of chunk 0 (tc = 16): its y1
    row t = 17 lies in chunk 0's single window and not in the triple one,
    and sets the chunk's y1 scale, so only the single staging's emulation
    equals the single plain version."""
    targs, _ = _case(48, seed=5, loud=18)
    single = emulate_block1(*targs, quantize=True, tc=16, mode="single")
    ref = tb1.block1_plain(*targs, quantize=True, tc=16, mode="single")
    triple = emulate_block1(*targs, quantize=True, tc=16, mode="triple")
    assert torch.equal(single, ref) and not torch.equal(triple, ref)


@pytest.mark.parametrize("mode", ["triple", "single"])
def test_row2_y1_chunk_maxes_by_block_equal_plain_scales(mode):
    """The y1 maxes taken per block of TT rows over the chunk's window
    give the plain version's chunk scales exactly."""
    targs, _ = _case(37, seed=3)
    info = {}
    emulate_block1(*targs, quantize=True, tc=16, mode=mode, info=info)
    x, w1, ab1 = targs[:3]
    halo = tb1.HALO[mode]
    sx = tb1.clip_scale(x)
    xq = tcb._quant_i8(x.float(), (1.0 / sx).float()[:, None, None])
    wq, s1 = tb1.conv1_weights(w1)
    mul = (ab1[0][None] * s1)[None] * sx.float()[:, None, None]
    nch, tc = 3, 16
    xpad = F.pad(xq.double(), (0, 0, halo, nch * tc + halo - 37))
    acc = torch.einsum("btmk,mkc->btmc", tb1._taps(xpad),
                       wq.double()).float()
    y1 = torch.relu(acc * mul[:, None] + ab1[1])
    win = y1.unfold(1, tc + 2 * halo, tc)             # [B, nch, 64, C, R]
    ref = win.amax(dim=(2, 3, 4)).reshape(-1)
    assert torch.equal(info["ymax"], ref)


@pytest.mark.parametrize("t", [37, 64])
def test_row2_conv1_mode_y1_bit_for_bit(t):
    """``"conv1"``: the dp4a conv1 writes the plain version's bf16 y1, in
    the mel-padded layout, zero in the pad columns and outside the clip."""
    targs, _ = _case(t, seed=t)
    info = {}
    emulate_block1(*targs, quantize="conv1", info=info)
    y1 = info["y1"]
    r_in, r_out = info["rows"]
    assert y1.shape == (2, t // 2 * 2 + 2, 66, 64) and r_out == t // 2 * 2
    assert not y1[:, :, 0].float().any() and not y1[:, :, -1].float().any()
    assert not y1[:, 0].float().any()                  # time -1
    ref = plain_conv1_y1(*targs[:3])
    n = min(t, r_in - 1)                               # times 0 .. n - 1
    assert torch.equal(y1[:, 1:1 + n, 1:-1], ref[:, :n])
    if r_in - 1 > t:
        assert not y1[:, t + 1:].float().any()


@pytest.mark.parametrize("quantize", ["conv1", False])
def test_row2_bf16_conv2_emulation_close_to_plain(quantize):
    targs, _ = _case(37, seed=9)
    got = emulate_block1(*targs, quantize=quantize)
    ref = tb1.block1_plain(*targs, quantize=quantize)
    assert got.shape == ref.shape
    assert _rel_rms(_np(got), _np(ref)) <= 1e-2


@pytest.mark.parametrize("quantize,tol", [("conv1", 5e-3), (False, 1e-2),
                                          (True, 5e-3)])
def test_row2_emulation_matches_pallas(quantize, tol):
    targs, jargs = _case(37, seed=37)
    ref = jb1.fused_block1_pair(*jargs, quantize=quantize, tc=16,
                                interpret=True)
    got = emulate_block1(*targs, quantize=quantize, tc=16)
    assert _rel_rms(_np(got), _np(ref)) <= tol


def test_row2_tiles_are_time_pairs_of_one_group():
    """conv2's tiles: 128 rows = one time pair × 64 mels, never across a
    group edge, none partial (R_out even)."""
    targs, _ = _case(37, seed=4)
    info = {}
    emulate_block1(*targs, quantize=True, tc=16, info=info)
    _, r_out = info["rows"]
    per_group = r_out * MELS
    assert per_group % BM == 0
    for p0, end, _ in info["tiles"]:
        assert end - p0 == BM and p0 // per_group == (end - 1) // per_group


def test_row2_scratch_layout():
    smax, y1 = tb1.scratch_v2(3, 37, 16, True, "cpu")
    assert smax.shape == (3 + 9,) and y1.shape == (9, 18, 66, 64)
    assert y1.dtype == torch.int8
    smax, y1 = tb1.scratch_v2(3, 37, 16, False, "cpu")
    assert smax.shape == (3,) and y1.shape == (3, 38, 66, 64)
    assert y1.dtype == torch.bfloat16
    smax, y1 = tb1.scratch_v2(3, 37, 16, "conv1", "cpu")  # y1 in shared mem
    assert smax.shape == (3,) and y1.numel() == 0


def test_row2_first_design_takes_cuda_tensors_only():
    targs, _ = _case(8, seed=1)
    with pytest.raises(ValueError):
        tb1._fused_block1_pair_v1(*targs, quantize="conv1")


# ------------------------------------------------------- row 1: log-mel

CFG = tfront.cnn8rnn_mel_config(32000)


def test_row1_interleaved_basis():
    real, imag, _ = tlm._trimmed_basis(CFG)
    basis = tlm.interleaved_basis(real, imag)
    assert basis.shape == (2 * real.shape[1], real.shape[0])
    np.testing.assert_array_equal(basis[0::2], real.T)
    np.testing.assert_array_equal(basis[1::2], imag.T)


def test_row1_mel_bands_rebuild_the_filterbank():
    fb = tlm._trimmed_basis(CFG)[2]
    band, weights = tlm.mel_bands(fb)
    rebuilt = np.zeros_like(fb)
    for m, (lo, hi, off) in enumerate(band):
        rebuilt[lo:hi, m] = weights[off:off + hi - lo]
        if hi > lo:
            assert fb[lo, m] != 0 and fb[hi - 1, m] != 0
    np.testing.assert_array_equal(rebuilt, fb)
    assert weights.size == band[-1, 2] + band[-1, 1] - band[-1, 0]
    assert weights.size < fb.size // 16          # band-limited


def band_mel(power: torch.Tensor, band, weights) -> torch.Tensor:
    """``logmel_v2_kernel``'s projection of ``power [R, 512]``: four passes
    of 128 bins, each mel's in-band bins in ascending f, ``m + p w`` in
    f32, carried across the passes."""
    mel = torch.zeros(power.shape[0], band.shape[0])
    w = torch.from_numpy(weights)
    for p in range(4):
        lo_p, hi_p = 128 * p, 128 * p + 128
        for m, (lo, hi, off) in enumerate(band.tolist()):
            for f in range(max(lo, lo_p), min(hi, hi_p)):
                mel[:, m] = mel[:, m] + power[:, f] * w[off + f - lo]
    return mel


def full_mel(power: torch.Tensor, fb: np.ndarray) -> torch.Tensor:
    """The full projection over all 512 bins in ascending f, ``m + p w``
    in f32."""
    fbt = torch.from_numpy(fb)
    mel = torch.zeros(power.shape[0], fb.shape[1])
    for f in range(fb.shape[0]):
        mel = mel + power[:, f:f + 1] * fbt[f]
    return mel


def test_row1_band_mel_equals_full_projection_bit_for_bit():
    fb = tlm._trimmed_basis(CFG)[2]
    band, weights = tlm.mel_bands(fb)
    rng = np.random.default_rng(0)
    power = torch.from_numpy(
        (rng.standard_exponential((24, fb.shape[0])) * 10.0 ** rng.uniform(
            -6, 2, (24, 1))).astype(np.float32))
    assert torch.equal(band_mel(power, band, weights), full_mel(power, fb))


def wave_pad(wave: torch.Tensor, npad: int) -> torch.Tensor:
    """``wave_pad_kernel``'s index arithmetic: sample i of the padded clip
    is x[reflect(i - 512)] below N + 512, else 0, cast to bf16."""
    n = wave.shape[1]
    j = torch.arange(npad) - 512
    keep = j < n + 512
    j = torch.where(j < 0, -j, torch.where(j >= n, 2 * (n - 1) - j, j))
    j = torch.where(keep, j, 0)
    return torch.where(keep, wave[:, j], 0.0).to(torch.bfloat16)


def emulate_logmel(wave: torch.Tensor) -> torch.Tensor:
    """The second design's log-mel on ``wave [B, N]`` f32."""
    b, n = wave.shape
    t = tfront.num_frames(n, CFG.hop_length)
    npad = tlm.npad_v2(t, CFG)
    xpad = wave_pad(wave, npad).float()
    real, imag, fb = tlm._trimmed_basis(CFG)
    basis = torch.from_numpy(tlm.interleaved_basis(real, imag)).to(
        torch.bfloat16).float()
    band, weights = tlm.mel_bands(fb)
    out = torch.empty(b, t, 64)
    for bi in range(b):
        for f0 in range(0, t, 128):
            frames = xpad[bi].unfold(0, 1024, 320)[f0:f0 + 128]
            assert frames.shape == (128, 1024)     # npad covers the tile
            power = torch.empty(128, 512)
            for p in range(4):
                acc = frames @ basis[256 * p:256 * p + 256].T
                re, im = acc[:, 0::2], acc[:, 1::2]
                power[:, 128 * p:128 * p + 128] = re * re + im * im
            mel = band_mel(power, band, weights)
            db = tlm._DB * torch.log(torch.clamp(mel, min=1e-10))
            out[bi, f0:f0 + 128] = db[:min(128, t - f0)]
    return out


def test_row1_wave_pad_equals_padded_bf16():
    wave = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 2000)).astype(np.float32))
    npad = tlm.npad_v2(tfront.num_frames(2000, 320), CFG)
    assert npad % 8 == 0 and npad >= (127 * 320 + 1024)
    assert torch.equal(wave_pad(wave, npad),
                       tlm._padded_bf16(wave, CFG, npad))


@pytest.mark.parametrize("n", [8000, 12345])
def test_row1_emulation_matches_plain_and_pallas(n):
    wave = (np.random.default_rng(n).normal(size=(2, n)) * 0.1).astype(
        np.float32)
    got = emulate_logmel(torch.from_numpy(wave))
    plain = tlm.log_mel_plain(torch.from_numpy(wave), CFG)
    ref = np.asarray(jlm.fused_log_mel_spectrogram(
        jnp.asarray(wave), jfront.cnn8rnn_mel_config(32000), interpret=True))
    assert got.shape == plain.shape == ref.shape == (2, n // 320 + 1, 64)
    assert float((got - plain).abs().max()) <= 2e-3
    assert np.max(np.abs(got.numpy() - ref)) <= 2e-3


def test_row1_first_design_takes_cuda_tensors_only():
    wave = torch.zeros(1, 4000)
    with pytest.raises(ValueError):
        tlm._fused_log_mel_spectrogram_v1(wave, CFG)
