"""The second design of rows 3 and 4 (``csrc/conv_igemm_sm90.cuh``),
emulated on the CPU in its own blocking.

The card's kernels cannot run here, so this file repeats their blocking
in PyTorch and holds the result to the plain versions bit for bit (int8)
and to the JAX kernels (``interpret=True``):

* the x scale maxes as many pieces of each scale window, each piece's max
  combined by max (``window_max_kernel`` and its ``atomicMax``): the whole
  clip for row 4, the chunk's flat pair-row window for row 3, whose
  windows overlap at the halo;
* ``xs [G, tc + 4, M + 2, Cin]`` and ``y1q [G, tc + 2, M + 2, C]`` with one
  zero mel column on each side (``pad_quant_kernel``, ``requant_kernel``);
* the GEMM over output positions (group, t, mel) enumerated row-major in
  tiles of 128 rows that cross group edges, the last tile partial, each
  tap's A rows read at a fixed offset from the padded layout;
* conv1's epilogue, whose y1 group maxes are taken per warp of 16 rows;
* conv2's pool windows read from inside one tile, in the first design's
  f32 order (mel pairs, then time pairs); with time pairs the tile's rows
  are permuted so that each window is rows k, k ^ 1 (mel pair, lanes l and
  l ^ 4) and k + 8, (k + 8) ^ 1 (the same thread's second fragment row).

``chip_smoke.py`` holds the kernels themselves to the plain versions and to
the first design on the card.  Tolerances: int8 bit for bit against the
plain version, relative RMS 5e-3 against the JAX kernel (int8 scales are per
chunk, so the frameworks agree to a metric, not bit for bit); bf16 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.ops.pallas import conv_block as jcb
from texttoaudiogrounding_tpu.ops.pallas import conv_block_pair as jb2
from texttoaudiogrounding_tpu_torch.ops.kernels import block2_small
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block_pair as tb2

BM = 128          # rows of a GEMM tile (two warpgroups of 64)
WARP_ROWS = 16    # rows of one warp's accumulator fragment
PIECE = 512       # elements of a window_max_kernel piece (8192 on the card)


def _scale(mx: torch.Tensor) -> torch.Tensor:
    """``scale_of``: max(m, 1e-6) / 127 as a true f32 division."""
    return tcb.over127(torch.clamp(mx, min=1e-6))


def window_maxes(x, tc: int, per_clip: bool, shrink: int = 0):
    """``smax`` of ``window_max_kernel``: one max a clip (row 4) or a group
    (row 3), combined over pieces of PIECE elements from the window's
    start.  Row 3's window of group (b, j) is the flat elements
    ``[j tc L - 2 L - 2 Cin, j tc L + (tc + 2) L + 2 Cin)`` of clip b, L =
    M Cin (``conv_block_v2.cu``); ``shrink`` cuts its halo by that many
    time rows on each side (a wrong window, for the loud-cell control)."""
    b, t, m, c = x.shape
    flat = x.float().abs().reshape(b, -1)
    n = flat.shape[1]
    nch = -(-t // tc)
    L = m * c
    wins = []
    for bi in range(b):
        if per_clip:
            wins.append((bi, 0, n))
            continue
        for j in range(nch):
            lo = j * tc * L - 2 * L - 2 * c + shrink * L
            hi = j * tc * L + (tc + 2) * L + 2 * c - shrink * L
            wins.append((bi, max(lo, 0), min(hi, n)))
    out = torch.zeros(len(wins))
    for gi, (bi, lo, hi) in enumerate(wins):
        for a0 in range(lo, hi, PIECE):
            out[gi] = torch.maximum(out[gi], flat[bi, a0:min(a0 + PIECE,
                                                             hi)].max())
    return out


def pad_quant(x, tc: int, scale_of_group):
    """``pad_quant_kernel``: xs ``[G, tc + 4, M + 2, Cin]``, row r of group
    (b, j) at time ``j tc + r - 2``, zero outside the clip and in the pad
    columns; int8 with the group's scale, or bf16 when it is None."""
    b, t, m, c = x.shape
    nch = -(-t // tc)
    xw = tcb._windows(x.float(), tc, 2, nch)
    if scale_of_group is not None:
        xw = tcb._quant_i8(xw, (1.0 / scale_of_group).reshape(-1, 1, 1, 1))
    else:
        xw = xw.to(torch.bfloat16)
    return torch.nn.functional.pad(xw, (0, 0, 1, 1))


def tile_perm(m: int, time_pairs: bool) -> torch.Tensor:
    """``perm``: the tile offset of tile row k; with time pairs warp W = k
    // 16 takes time pair W // (M / 8), mels 8 (W % (M / 8)) + [0, 8), its
    rows k % 16 // 8 the two times."""
    k = torch.arange(BM)
    if not time_pairs:
        return k
    w, mg = k // 16, m // 8
    return (2 * (w // mg) + (k // 8) % 2) * m + (w % mg) * 8 + k % 8


def igemm(src, wk, r_out: int, tiles: list, perm: torch.Tensor):
    """The implicit GEMM of ``igemm_kernel`` over ``src [G, R_in, M + 2,
    Cin]`` and weights ``wk [Cout, 9 Cin]``: positions (g, r, m) row-major
    in tiles of BM rows, tile row k at position ``p0 + perm[k]``, rows past
    the end read the last position; each tap (dt, dm) reads cell ``((g R_in
    + r)(M + 2) + m) + dt (M + 2) + dm``.  Returns the sums ``[P, Cout]``
    (float64: exact for int8) and appends each tile's (first, end,
    position -> tile row) to ``tiles``."""
    g, r_in, mp, cin = src.shape
    m = mp - 2
    cells = src.reshape(-1, cin)
    n_pos = g * r_out * m
    acc = torch.empty(n_pos, wk.shape[0], dtype=torch.float64)
    wd = wk.double() if wk.dtype == torch.int8 else wk.float()
    inv = torch.argsort(perm)
    for p0 in range(0, n_pos, BM):
        p = (p0 + perm).clamp(max=n_pos - 1)
        gp, rp, mm = p // (r_out * m), (p // m) % r_out, p % m
        base = (gp * r_in + rp) * mp + mm
        a = torch.cat([cells[base + dt * mp + dm] for dt in range(3)
                       for dm in range(3)], dim=1)
        a = a.double() if wk.dtype == torch.int8 else a.float()
        rows = (a @ wd.T).double()
        end = min(p0 + BM, n_pos)
        acc[p0:end] = rows[inv[:end - p0]]
        tiles.append((p0, end, inv))
    return acc


def conv1_epilogue(acc, alpha, beta, gscale, nch, tc, t, r_out, m):
    """conv1's epilogue: ``relu(acc * (alpha * scale) + beta)`` in f32,
    zero outside the clip; the y1 group maxes from each warp's 16 rows (one
    max where they lie in one group, else one a row), combined by max."""
    n_pos = acc.shape[0]
    p = torch.arange(n_pos)
    g, r = p // (r_out * m), (p // m) % r_out
    time = (g % nch) * tc + r - 1
    mul = alpha[None] * gscale[g][:, None] if gscale is not None \
        else alpha[None].expand(n_pos, -1)
    y = torch.relu(acc.float() * mul + beta)
    y = torch.where(((time >= 0) & (time < t))[:, None], y, 0.0)
    ymax = torch.zeros(int(g[-1]) + 1)
    for w0 in range(0, n_pos, WARP_ROWS):
        rows = slice(w0, min(w0 + WARP_ROWS, n_pos))
        for gi in torch.unique(g[rows]):
            sel = g[rows] == gi
            ymax[gi] = torch.maximum(ymax[gi], y[rows][sel].max())
    return y, ymax


def conv2_pool(acc, alpha, beta, gscale, b, nch, tc, t, m, pool, tiles):
    """conv2's epilogue: ``relu(acc * (alpha * scale) + beta)``, then each
    pool window, which must lie inside one tile, summed and maxed over the
    mel pair, then the time pair; ``sum / (pt pm) + max`` in f32, rows of
    chunks past the clip dropped."""
    pt, pm = pool
    n_pos, cout = acc.shape
    g = torch.arange(n_pos) // (tc * m)
    mul = alpha[None] * gscale[g][:, None] if gscale is not None \
        else alpha[None].expand(n_pos, -1)
    y = torch.relu(acc.float() * mul + beta)
    tile_of = torch.empty(n_pos, dtype=torch.long)
    row_of = torch.empty(n_pos, dtype=torch.long)
    for k, (p0, end, inv) in enumerate(tiles):
        tile_of[p0:end] = k
        row_of[p0:end] = inv[:end - p0]
    out = torch.zeros(b, t // pt, m // pm, cout)
    for p in range(0, n_pos):
        gi, r, mm = p // (tc * m), (p // m) % tc, p % m
        if r % pt or mm % pm:
            continue
        rows = [[p + di * m + dj for dj in range(pm)] for di in range(pt)]
        assert len({int(tile_of[q]) for row in rows for q in row}) == 1
        k = int(row_of[p])         # the window's fragment rows and lanes
        assert [[int(row_of[q]) for q in row] for row in rows] == [
            [k + 8 * di + dj for dj in range(pm)] for di in range(pt)]
        s = [y[row[0]] + y[row[1]] if pm == 2 else y[row[0]]
             for row in rows]
        mx = [torch.maximum(y[row[0]], y[row[1]]) if pm == 2 else y[row[0]]
              for row in rows]
        big_s = s[0] + s[1] if pt == 2 else s[0]
        big_m = torch.maximum(mx[0], mx[1]) if pt == 2 else mx[0]
        bi, j = divmod(gi, nch)
        tout = (j * tc + r) // pt
        if tout < t // pt:
            out[bi, tout, mm // pm] = big_s * (1.0 / (pt * pm)) + big_m
    return out.to(torch.bfloat16)


def emulate(x, w1, ab1, w2, ab2, pool, *, quantize: bool, tc: int,
            per_clip: bool, divide: bool = False, shrink: int = 0,
            info: dict | None = None):
    """The second design's block on ``x [B, T, M, Cin]`` bf16."""
    b, t, m, _ = x.shape
    nch = -(-t // tc)
    w1k, a1, b1, w2k, a2, b2 = tcb.kernel_weights(w1, ab1, w2, ab2,
                                                  quantize, divide)
    tiles1, tiles2 = [], []
    if quantize:
        smax = window_maxes(x, tc, per_clip, shrink)
        sx = _scale(smax)
        sx = sx.repeat_interleave(nch) if per_clip else sx
        xs = pad_quant(x, tc, sx)
    else:
        sx = None
        xs = pad_quant(x, tc, None)
    acc1 = igemm(xs, w1k, tc + 2, tiles1, tile_perm(m, False))
    y1, ymax = conv1_epilogue(acc1, a1, b1, sx, nch, tc, t, tc + 2, m)
    y1 = y1.reshape(b * nch, tc + 2, m, -1)
    if quantize:
        sy = _scale(ymax)
        y1q = tcb._quant_i8(y1, (1.0 / sy).reshape(-1, 1, 1, 1))
    else:
        sy = None
        y1q = y1.to(torch.bfloat16)
    y1q = torch.nn.functional.pad(y1q, (0, 0, 1, 1))
    acc2 = igemm(y1q, w2k, tc, tiles2, tile_perm(m, pool[0] == 2))
    if info is not None:
        info.update(tiles1=tiles1, tiles2=tiles2, xs=xs, y1q=y1q,
                    groups_rows=((tc + 2) * m, tc * m))
    return conv2_pool(acc2, a2, b2, sy, b, nch, tc, t, m, pool, tiles2)


def _case(t, m, cin, cout, seed, loud=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, m, cin)).astype(np.float32)
    if loud is not None:
        x *= 0.05
        x[loud] = 40.0
    w1 = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, cout, cout)) * 0.05).astype(np.float32)
    ab = [(rng.uniform(0.5, 1.5, cout).astype(np.float32),
           (rng.normal(size=cout) * 0.1).astype(np.float32))
          for _ in range(2)]
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    targs = (tx, torch.from_numpy(w1), tuple(map(torch.from_numpy, ab[0])),
             torch.from_numpy(w2), tuple(map(torch.from_numpy, ab[1])))
    jargs = (jx, jnp.asarray(w1), tuple(map(jnp.asarray, ab[0])),
             jnp.asarray(w2), tuple(map(jnp.asarray, ab[1])))
    return targs, jargs


def _rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _np(out):
    return out.float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)


# ------------------------------------------------------------ the blocking

def test_tiles_cross_groups_and_the_last_is_partial():
    """At T = 10, tc = 4, M = 8 a conv1 group has 48 rows: the 128-row
    tiles straddle group edges, the chunk of the last group is ragged and
    only the call's last tile is partial."""
    targs, _ = _case(10, 8, 64, 128, seed=1)
    info = {}
    emulate(*targs, (1, 2), quantize=True, tc=4, per_clip=True, info=info)
    rows1, _ = info["groups_rows"]
    tiles = info["tiles1"]
    assert len(tiles) == -(-6 * rows1 // BM)        # 6 groups, one call
    straddle = [(p0, e) for p0, e, _ in tiles
                if p0 // rows1 != (e - 1) // rows1]
    assert len(straddle) >= 2
    assert all(e - p0 == BM for p0, e, _ in tiles[:-1])
    assert tiles[-1][1] - tiles[-1][0] < BM


def test_padded_layouts_hold_zero_pad_columns():
    targs, _ = _case(12, 8, 64, 128, seed=2)
    info = {}
    emulate(*targs, (2, 2), quantize=True, tc=4, per_clip=False, info=info)
    for buf in (info["xs"], info["y1q"]):
        assert buf.dtype == torch.int8
        assert not buf[:, :, 0].any() and not buf[:, :, -1].any()
        assert buf[:, :, 1:-1].any()


@pytest.mark.parametrize("per_clip", [True, False])
def test_window_maxes_match_the_plain_scales(per_clip):
    """The piecewise maxes give the plain version's scales exactly."""
    targs, _ = _case(20, 8, 64, 128, seed=3)
    x, tc = targs[0], 4
    nch = 5
    got = _scale(window_maxes(x, tc, per_clip))
    if per_clip:
        ref = tcb.per_clip_scale(x.float(), tc, nch)[:, 0]
    else:
        ref = tb2.pair_window_scale(x.float(), tc, nch).reshape(-1)
    assert torch.equal(got, ref)


# ------------------------------------------------- row 4 (blocks 3 and 4)

@pytest.mark.parametrize("t,tc,pool,m", [(10, 4, (1, 2), 8),
                                         (12, 4, (2, 2), 8),
                                         (12, 6, (1, 2), 8),
                                         (12, 4, (2, 2), 16)])
def test_row4_emulation_equals_plain_int8(t, tc, pool, m):
    targs, _ = _case(t, m, 64, 128, seed=t * tc + m)
    got = emulate(*targs, pool, quantize=True, tc=tc, per_clip=True)
    ref = tcb.double_conv_plain(*targs, pool, quantize=True, tc=tc)
    assert torch.equal(got, ref)


def test_row4_emulation_bf16_close_to_plain():
    targs, _ = _case(10, 8, 64, 128, seed=11)
    got = emulate(*targs, (1, 2), quantize=False, tc=4, per_clip=True)
    ref = tcb.double_conv_plain(*targs, (1, 2), quantize=False, tc=4)
    assert _rel_rms(_np(got), _np(ref)) <= 1e-2


@pytest.mark.parametrize("quantize,tol", [(True, 5e-3), (False, 1e-2)])
def test_row4_emulation_matches_pallas(quantize, tol):
    targs, jargs = _case(12, 8, 128, 256, seed=12)
    ref = jcb.fused_double_conv_pool(*jargs, (1, 2), quantize=quantize,
                                     tc=4, interpret=True)
    got = emulate(*targs, (1, 2), quantize=quantize, tc=4, per_clip=True)
    assert _rel_rms(_np(got), _np(ref)) <= tol


# ------------------------------------------------------ row 3 (block 2)

@pytest.mark.parametrize("t,tc,m", [(12, 4, 8), (20, 4, 8), (12, 6, 8),
                                    (12, 4, 32)])
def test_row3_emulation_equals_plain_int8(t, tc, m):
    targs, _ = _case(t, m, 64, 128, seed=t + tc + m)
    got = emulate(*targs, (2, 2), quantize=True, tc=tc, per_clip=False)
    ref = tb2.block2_plain(*targs, quantize=True, tc=tc)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("quantize,tol", [(True, 5e-3), (False, 1e-2)])
def test_row3_emulation_matches_pallas(quantize, tol):
    targs, jargs = _case(20, 8, 64, 128, seed=20)
    ref = jb2.fused_block2_pair(*jargs, quantize=quantize, tc=4,
                                interpret=True)
    got = emulate(*targs, (2, 2), quantize=quantize, tc=4, per_clip=False)
    assert _rel_rms(_np(got), _np(ref)) <= tol


# time 9 = j tc + tc + 1 of chunk 1 (tc = 4): its last halo row (chunk 2's
# core); time 1 = j tc - 3 of chunk 1, mel 7: the last cell of the extra
# pair row the window holds before its halo
@pytest.mark.parametrize("loud", [(0, 9, 3, 5), (1, 1, 7, 60)])
def test_row3_loud_halo_cell_needs_the_right_window(loud):
    """One loud cell that only chunk 1's own window sees sets that chunk's
    x scale: the emulation equals the plain version, and a window one halo
    row short on each side does not."""
    targs, _ = _case(16, 8, 64, 128, seed=7, loud=loud)
    ref = tb2.block2_plain(*targs, quantize=True, tc=4)
    got = emulate(*targs, (2, 2), quantize=True, tc=4, per_clip=False)
    assert torch.equal(got, ref)
    short = emulate(*targs, (2, 2), quantize=True, tc=4, per_clip=False,
                    shrink=1)
    assert not torch.equal(short, ref)


def test_row6_odd_t_small_chunk_equals_plain():
    """Row 6 on row 3's kernel: tc 2 (``block2_small.default_tc``), odd T
    (a ragged last chunk and a dropped trailing frame), divided weights."""
    targs, _ = _case(13, 8, 64, 128, seed=13)
    tc = block2_small.default_tc(13)
    got = emulate(*targs, (2, 2), quantize=True, tc=tc, per_clip=False,
                  divide=True)
    ref = tb2.block2_plain(*targs, quantize=True, tc=tc, divide=True)
    assert got.shape == (2, 6, 4, 128) and torch.equal(got, ref)


@pytest.mark.parametrize("m", [8, 16, 32, 64])
def test_time_pair_permutation_is_a_tile_permutation(m):
    """Each thread's rows k and k + 8 are one mel's two times, lanes l and
    l ^ 4 (rows k, k ^ 1) neighbouring mels, and every row of the tile is
    taken once."""
    perm = tile_perm(m, True)
    assert sorted(perm.tolist()) == list(range(BM))
    k = torch.arange(BM)
    lo = k[(k // 8) % 2 == 0]
    assert torch.equal(perm[lo + 8], perm[lo] + m)
    assert torch.equal(perm[lo ^ 1], perm[lo] ^ 1)
    assert ((perm[lo] // m) % 2 == 0).all()


def test_first_design_takes_cuda_tensors_only():
    """The first design is kept only to be timed beside the second on the
    card; a CPU tensor is refused before any build."""
    targs, _ = _case(8, 8, 64, 128, seed=3)
    with pytest.raises(ValueError):
        tcb._fused_double_conv_pool_v1(*targs, (1, 2), quantize=True, tc=4)


def test_v2_pool_check_rejects_unaligned_windows():
    tcb.check_v2_pool(8, (2, 2))
    tcb.check_v2_pool(24, (1, 2))
    for m in (4, 24, 128):
        with pytest.raises(ValueError):
            tcb.check_v2_pool(m, (2, 2))
