"""Row 4 mel3's and row 5's second designs, emulated on the CPU in their
own blockings.

The card's kernels cannot run here, so this file repeats their blockings
in PyTorch and holds them to the plain versions bit for bit in int8:

* the x scales as ``window_max_kernel`` takes them, pieces of each
  window's flat elements combined by max, with the windows the C entries
  pass: mel3's reaches one cell past its staged times
  (``conv_block_mel3_v2.cu``), row 5's is row 3's pair-row window
  (``pair_conv_pool_v2.cu``);
* the bf16-stored y1 of conv1's MODE 4 epilogue: each value rounded to
  bf16, the group maxes over the rounded values by warp (16 rows, tiles
  crossing groups), and ``requant_kernel`` on bf16;
* mel3's block with both convs in the slab form (``slab_conv_emulated``)
  and its window and rounded y1 (``double_conv_plain``'s hooks);
* row 5's full block in the per-tap GEMM's blocking
  (``tests/test_torch_port_conv_igemm.py``: 128-row tiles that cross
  groups, the last partial, time pairs permuted within a tile);
* row 5's conv2 without conv1 read from the caller's unpadded clip, each
  tap cell outside the clip's times or mels a zero-filling copy, which
  must read what a padded copy holds.

Each case crosses groups with its tiles and ends in a partial tile.  The
plain versions are held to the JAX kernels by
``tests/test_torch_port_mel3_tri.py`` and ``test_torch_port_block12.py``;
here one JAX call (interpret mode) holds the mel3 emulation to it at the
row-4 int8 bound.  ``chip_smoke.py`` holds the kernels themselves to the
plain versions and to the first designs on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import test_torch_port_conv_igemm as ig
from tests.test_torch_port_kernels import (_bf16, _block_case, _jab,
                                           _rel_rms, _tab, _to_np)
from texttoaudiogrounding_tpu.ops.pallas import conv_block as jcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block_pair as tb2
from texttoaudiogrounding_tpu_torch.ops.kernels import pair_conv_pool as tpc

INT8_TOL, BF16_TOL = 5e-3, 1e-2
WARP_ROWS = 16
# mel3: M = 8, tc = 5, a ragged last chunk; conv1's slab rows are 9 times
# a group (72 positions), conv2's 7 (56): 6 groups in 432 / 336 positions
MEL3_T, MEL3_TC, MEL3_POOL = 11, 5, (1, 2)
# row 5: conv1 48 rows a group, 6 groups in 288 rows (tiles 128, 128, 32);
# conv2 32 a group, 192 rows; conv2 alone 96 a clip, 192 rows
PAIR_T, PAIR_TC = 12, 4


def _torch_case(t, m, cin, cout, seed):
    x, w1, ab1, w2, ab2 = _block_case(t, m, cin, cout, seed=seed)
    return (_bf16(x)[1], torch.from_numpy(w1), _tab(ab1),
            torch.from_numpy(w2), _tab(ab2))


@pytest.fixture(scope="module")
def mel3_case():
    return _torch_case(MEL3_T, 8, 64, 64, seed=15)


@pytest.fixture(scope="module")
def pair_case():
    return _torch_case(PAIR_T, 8, 64, 128, seed=5)


@pytest.fixture(scope="module")
def act_case():
    """Row 5 without conv1: a non-negative activation [2, T, 8, 64] as
    int8 with one scale, and as bf16; conv2's weights."""
    rng = np.random.default_rng(9)
    act = np.abs(rng.normal(size=(2, PAIR_T, 8, 64))).astype(np.float32)
    xs = float(act.max()) / 127.0
    xq = np.clip(np.round(act / xs), -127, 127).astype(np.int8)
    *_, w2, ab2 = _block_case(PAIR_T, 8, 64, 64, seed=10)
    return (torch.from_numpy(xq), _bf16(act)[1], xs, torch.from_numpy(w2),
            _tab(ab2))


# --------------------------------------------------------- the x windows

def mel3_window(tc: int, m: int, cin: int) -> tuple:
    """(win_step, win_lo, win_hi) of ``ttg_conv_block_mel3_v2``."""
    return tc * m * cin, -(2 * m + 1) * cin, ((tc + 2) * m + 1) * cin


def pair_window(tc: int, m: int, cin: int) -> tuple:
    """(win_step, win_lo, win_hi) of ``ttg_pair_conv_pool_v2``."""
    el = m * cin
    return tc * el, -2 * el - 2 * cin, (tc + 2) * el + 2 * cin


def window_maxes(x, tc: int, window: tuple, piece: int) -> torch.Tensor:
    """``window_max_kernel``'s maxes ``[B, nch]``: group (b, j) takes the
    flat elements ``[j step + lo, j step + hi)`` of clip b, clipped to the
    clip, in pieces of ``piece`` elements from the window's start, each
    piece's max combined by max (``atomicMax``)."""
    b, t = x.shape[:2]
    flat = x.float().abs().reshape(b, -1)
    n, nch = flat.shape[1], -(-t // tc)
    step, lo, hi = window
    out = torch.zeros(b, nch)
    for bi in range(b):
        for j in range(nch):
            a0, a1 = max(j * step + lo, 0), min(j * step + hi, n)
            for p0 in range(a0, a1, piece):
                out[bi, j] = torch.maximum(
                    out[bi, j], flat[bi, p0:min(p0 + piece, a1)].max())
    return out


def x_scale_of(window_fn, piece: int = 512):
    """``double_conv_plain``'s ``x_scale`` hook from the kernel's window
    maxes (``scale_of``)."""
    def x_scale(xf, tc, nch):
        m, cin = xf.shape[2:]
        return ig._scale(window_maxes(xf, tc, window_fn(tc, m, cin), piece))
    return x_scale


@pytest.mark.parametrize("piece", [64, 512, 10 ** 6])
def test_window_maxes_are_the_plain_scales(mel3_case, pair_case, piece):
    x = mel3_case[0].clone()
    x[:, MEL3_TC + 2, 0] = 9.0          # one cell past chunk 0's times
    nch = -(-MEL3_T // MEL3_TC)
    got = x_scale_of(mel3_window, piece)(x.float(), MEL3_TC, nch)
    assert torch.equal(got, tcb.mel3_window_scale(x.float(), MEL3_TC, nch))
    xp = pair_case[0]
    got = x_scale_of(pair_window, piece)(xp.float(), PAIR_TC,
                                         PAIR_T // PAIR_TC)
    assert torch.equal(got, tb2.pair_window_scale(
        xp.float(), PAIR_TC, PAIR_T // PAIR_TC))


# ------------------------------------------------ the bf16-stored y1

def half_epilogue(y: torch.Tensor, rows: int) -> tuple:
    """MODE 4 on conv1's f32 rows ``[P, C]`` in position order (``rows``
    a group): each value rounded to bf16 and stored so; each warp's 16
    rows give one max a group they hold, over the rounded values, combined
    by max.  Returns (the stored bf16 rows, the group maxes)."""
    yh = y.to(torch.bfloat16)
    yr = yh.float()
    g = torch.arange(y.shape[0]) // rows
    ymax = torch.zeros(int(g[-1]) + 1)
    for w0 in range(0, y.shape[0], WARP_ROWS):
        gw, vw = g[w0:w0 + WARP_ROWS], yr[w0:w0 + WARP_ROWS]
        for gi in torch.unique(gw):
            ymax[gi] = torch.maximum(ymax[gi], vw[gw == gi].max())
    return yh, ymax


def requant_half(yh: torch.Tensor, ymax: torch.Tensor) -> torch.Tensor:
    """``requant_kernel<bf16>``: ``y1q [G, R, M + 2, C]`` from the bf16 y1
    ``[G, R, M, C]``, each value to f32 and quantized with its group's
    scale, zero pad columns."""
    inv = (1.0 / ig._scale(ymax)).reshape(-1, 1, 1, 1)
    return F.pad(tcb._quant_i8(yh.float(), inv), (0, 0, 1, 1))


def test_rounded_max_and_requantized_y1():
    """The max of the rounded values is the rounded max; a group whose f32
    max rounds up to the next bf16 value takes the rounded scale, and
    ``requant_kernel<bf16>`` then gives the plain version's y1q, which the
    f32 max's scale would not."""
    rng = np.random.default_rng(4)
    g, r, m, c = 3, 6, 8, 64
    y = torch.from_numpy(np.abs(rng.normal(size=(g, r, m, c)) * 0.5)
                         .astype(np.float32))
    # group 1's max between two bf16 values, nearer the upper one
    y[1, 2, 3, 5] = 4.0 + 0.75 * 2.0 ** -5
    flat = y.reshape(-1, c)
    yh, ymax = half_epilogue(flat, r * m)
    f32_max = y.amax(dim=(1, 2, 3))
    assert torch.equal(ymax, f32_max.to(torch.bfloat16).float())
    assert ymax[1] > f32_max[1]
    plain = y.to(torch.bfloat16).float()
    sy = tcb.over127(torch.clamp(plain.amax(dim=(1, 2, 3)), min=1e-6))
    ref = tcb._quant_i8(plain, (1.0 / sy).reshape(-1, 1, 1, 1))
    got = requant_half(yh.reshape(g, r, m, c), ymax)
    assert torch.equal(got[:, :, 1:-1], ref)
    assert not got[:, :, 0].any() and not got[:, :, -1].any()
    unrounded = tcb._quant_i8(plain, (1.0 / ig._scale(f32_max)).reshape(
        -1, 1, 1, 1))
    assert not torch.equal(unrounded, ref)


# ------------------------------------------------------- row 4, mel3

def mel3_emulated(x, w1, ab1, w2, ab2, pool, *, mel3=(True, True),
                  piece: int = 512):
    """The second mel3 design in int8: the kernel's window maxes, conv1
    rows rounded to bf16 before their scale with a mel3 conv2, both convs
    in the slab form."""
    return tcb.double_conv_plain(
        x, w1, ab1, w2, ab2, pool, quantize=True, tc=MEL3_TC,
        x_scale=x_scale_of(mel3_window, piece), round_y1=mel3[1],
        conv=tcb.slab_conv_emulated)


@pytest.mark.parametrize("mel3", [(True, True), (True, False)],
                         ids=["TT", "TF"])
def test_mel3_emulated_is_plain_bit_for_bit(mel3_case, mel3):
    # the slab tiles cross groups and the last is partial, in both convs
    for rows in (MEL3_TC + 4, MEL3_TC + 2):
        n_pos = 2 * -(-MEL3_T // MEL3_TC) * rows * 8
        assert n_pos % tcb.SLAB_BM and tcb.SLAB_BM % (rows * 8)
    modes = tcb.tap_modes(64, True, mel3)
    ref = tcb.block_plain(*mel3_case, MEL3_POOL, quantize=True, tc=MEL3_TC,
                          modes=modes)
    got = mel3_emulated(*mel3_case, MEL3_POOL, mel3=mel3)
    assert torch.equal(got, ref)
    # (True, False): conv2 on direct9's per-tap GEMM, f32 y1
    if mel3 == (True, False):
        assert torch.equal(got, tcb.double_conv_plain(
            *mel3_case, MEL3_POOL, quantize=True, tc=MEL3_TC,
            x_scale=x_scale_of(mel3_window)))
    # the per-clip scale and f32 y1 of direct9 give other bits
    assert not torch.equal(got, tcb.block_plain(
        *mel3_case, MEL3_POOL, quantize=True, tc=MEL3_TC))


def test_mel3_emulated_matches_pallas(mel3_case):
    """At whole chunks (the JAX kernel leaves a ragged chunk's rows
    undefined): T = 10, two chunks of 5."""
    x, w1, ab1, w2, ab2 = mel3_case
    x = x[:, :2 * MEL3_TC].contiguous()
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    ref = jcb.fused_double_conv_pool(
        jx, jnp.asarray(w1.numpy()), _jab(tuple(v.numpy() for v in ab1)),
        jnp.asarray(w2.numpy()), _jab(tuple(v.numpy() for v in ab2)),
        MEL3_POOL, quantize=True, tc=MEL3_TC, mel3=(True, True),
        interpret=True)
    got = mel3_emulated(x, w1, ab1, w2, ab2, MEL3_POOL)
    assert _rel_rms(_to_np(got), _to_np(ref)) <= INT8_TOL


def test_mel3_bf16_runs_tri_launches(mel3_case):
    """mel3's bf16 mode is tri's function at tri's chunk: the same design,
    the same slab convs, the same plain bits; int8 mel3 keeps its own
    design."""
    for m, pool in ((16, (1, 2)), (16, (2, 2)), (4, (1, 2)), (24, (1, 2))):
        mel3 = tcb.slab_plan(tcb.tap_modes(64, False, (True, True)), False,
                             m, pool)
        tri = tcb.slab_plan(tcb.tap_modes(64, False, None, (True, True)),
                            False, m, pool)
        assert mel3[:3] == tri[:3] and mel3[0] == "tri_v2"
        assert mel3[3] == tri[3].replace("tri", "mel3")
    shape = (2, 500, 16, 128)                  # the same bf16 chunk
    assert tcb.block_tc(shape, 256, MEL3_POOL, False, tcb.tap_modes(
        128, False, (True, True))) == tcb.block_tc(
            shape, 256, MEL3_POOL, False,
            tcb.tap_modes(128, False, None, (True, True)))
    out = {kw: tcb.fused_double_conv_pool(*mel3_case, MEL3_POOL, **{
        kw: (True, True)}) for kw in ("mel3", "tri")}
    assert torch.equal(out["mel3"], out["tri"])
    assert tcb.slab_plan((True, True, False, False), True, 8, (1, 2)) == (
        "mel3_v2", True, True, "conv_block_mel3")


# ------------------------------------------------------ row 5, full block

def pair_emulated(x, w1, ab1, w2, ab2, pool, *, quantize: bool, tc: int,
                  tiles: dict | None = None):
    """The second row-5 design: row 3's window maxes and padded int8 input,
    conv1 in the per-tap GEMM's tiles, MODE 4's bf16 y1 (int8), conv2 at
    pool (pt, 2) with time pairs permuted within a tile."""
    b, t, m, cin = x.shape
    nch = t // tc
    w1k, a1, b1, w2k, a2, b2 = tcb.kernel_weights(w1, ab1, w2, ab2,
                                                  quantize)
    t1, t2 = [], []
    sx = (ig._scale(window_maxes(x, tc, pair_window(tc, m, cin), 512))
          .reshape(-1) if quantize else None)
    xs = ig.pad_quant(x, tc, sx)
    acc1 = ig.igemm(xs, w1k, tc + 2, t1, ig.tile_perm(m, False))
    y1, _ = ig.conv1_epilogue(acc1, a1, b1, sx, nch, tc, t, tc + 2, m)
    shape = (b * nch, tc + 2, m, -1)
    if quantize:
        yh, ymax = half_epilogue(y1, (tc + 2) * m)
        y1q, sy = requant_half(yh.reshape(shape), ymax), ig._scale(ymax)
    else:
        y1q, sy = F.pad(y1.reshape(shape).to(torch.bfloat16),
                        (0, 0, 1, 1)), None
    acc2 = ig.igemm(y1q, w2k, tc, t2, ig.tile_perm(m, pool[0] == 2))
    if tiles is not None:
        tiles.update(conv1=t1, conv2=t2, rows=((tc + 2) * m, tc * m))
    return ig.conv2_pool(acc2, a2, b2, sy, b, nch, tc, t, m, pool, t2)


@pytest.mark.parametrize("pt", [2, 1])
def test_pair_emulated_is_plain_bit_for_bit(pair_case, pt):
    tiles = {}
    got = pair_emulated(*pair_case, (pt, 2), quantize=True, tc=PAIR_TC,
                        tiles=tiles)
    ref = tpc.pair_conv_pool_plain(*pair_case, (pt, 2), quantize=True,
                                   tc=PAIR_TC)
    assert torch.equal(got, ref)
    for conv, rows in zip(("conv1", "conv2"), tiles["rows"]):
        spans = [(p0, e) for p0, e, _ in tiles[conv]]
        assert any(p0 // rows != (e - 1) // rows for p0, e in spans)
        assert spans[-1][1] - spans[-1][0] < ig.BM


def test_pair_emulated_bf16(pair_case):
    got = pair_emulated(*pair_case, (2, 2), quantize=False, tc=PAIR_TC)
    ref = tpc.pair_conv_pool_plain(*pair_case, (2, 2), quantize=False,
                                   tc=PAIR_TC)
    assert _rel_rms(_to_np(got), _to_np(ref)) <= BF16_TOL


# ---------------------------------------------- row 5, conv2 without conv1

def zfill_taps(src: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The A rows of positions ``p`` of ``igemm_kernel`` ZFILL over the
    unpadded ``src [G, R, M, C]``: tap (dt, dm) reads the position's own
    cell moved by ``(dt - 1) M + dm - 1`` cells when time ``r + dt - 1``
    and mel ``m + dm - 1`` lie inside the group, else 16-byte zero fills.
    Returns ``[len(p), 9 C]`` in tap order."""
    g, r, m, c = src.shape
    cells = src.reshape(-1, c)
    rp, mp = (p // m) % r, p % m
    taps = []
    for dt in range(3):
        for dm in range(3):
            rr, mm = rp + dt - 1, mp + dm - 1
            inside = (rr >= 0) & (rr < r) & (mm >= 0) & (mm < m)
            at = torch.where(inside, p + (dt - 1) * m + dm - 1, 0)
            taps.append(torch.where(inside[:, None], cells[at],
                                    torch.zeros((), dtype=src.dtype)))
    return torch.cat(taps, dim=1)


def zfill_igemm(src, wk, perm, tiles: list) -> torch.Tensor:
    """:func:`ig.igemm` with the zero-filled A rows of :func:`zfill_taps`."""
    g, r, m, _ = src.shape
    n_pos = g * r * m
    acc = torch.empty(n_pos, wk.shape[0], dtype=torch.float64)
    wd = wk.double() if wk.dtype == torch.int8 else wk.float()
    inv = torch.argsort(perm)
    for p0 in range(0, n_pos, ig.BM):
        p = (p0 + perm).clamp(max=n_pos - 1)
        a = zfill_taps(src, p)
        rows = ((a.double() if wk.dtype == torch.int8 else a.float())
                @ wd.T).double()
        end = min(p0 + ig.BM, n_pos)
        acc[p0:end] = rows[inv[:end - p0]]
        tiles.append((p0, end, inv))
    return acc


def test_zero_filled_taps_read_a_padded_copy(act_case):
    xq = act_case[0]
    g, r, m, c = xq.shape
    cells = F.pad(xq, (0, 0, 1, 1, 1, 1)).reshape(-1, c)
    p = torch.arange(g * r * m)
    gp, rp, mp = p // (r * m), (p // m) % r, p % m
    want = torch.cat([cells[(gp * (r + 2) + rp + dt) * (m + 2) + mp + dm]
                      for dt in range(3) for dm in range(3)], dim=1)
    assert torch.equal(zfill_taps(xq, p), want)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("pt", [2, 1])
def test_pair_conv2_only_emulated(act_case, quantize, pt):
    """One group a clip over the unpadded clip, the x scale folded into
    alpha2: int8 bit for bit, bf16 within 1e-2 of the plain version."""
    xq, x16, xs, w2, ab2 = act_case
    x = xq if quantize else x16
    w2k, a2, b2 = tpc.prepare(None, None, w2, ab2, quantize,
                              xs if quantize else None)[:3]
    b, t, m, _ = x.shape
    tiles = []
    acc = zfill_igemm(x, w2k, ig.tile_perm(m, pt == 2), tiles)
    assert tiles[0][1] > t * m and tiles[-1][1] - tiles[-1][0] < ig.BM
    got = ig.conv2_pool(acc, a2, b2, None, b, 1, t, t, m, (pt, 2), tiles)
    ref = tpc.pair_conv_pool_plain(x, None, None, w2, ab2, (pt, 2),
                                   quantize=quantize, tc=PAIR_TC,
                                   x_scale=xs if quantize else None)
    if quantize:
        assert torch.equal(got, ref)
    else:
        assert _rel_rms(_to_np(got), _to_np(ref)) <= BF16_TOL


# -------------------------------------------------- first designs, checks

def test_first_designs_raise_on_cpu(mel3_case, pair_case, act_case):
    with pytest.raises(ValueError, match="CUDA"):
        tcb._fused_mel3_v1(*mel3_case, MEL3_POOL, quantize=True, tc=MEL3_TC)
    with pytest.raises(ValueError, match="CUDA"):
        tpc._fused_pair_conv_pool_v1(*pair_case, quantize=True, tc=PAIR_TC)
    xq, _, xs, w2, ab2 = act_case
    with pytest.raises(ValueError, match="CUDA"):
        tpc._fused_pair_conv_pool_v1(xq, None, None, w2, ab2, quantize=True,
                                     tc=PAIR_TC, x_scale=xs)


def test_route_and_shape_checks():
    """mel3 goes by shape as tri does, each route its own counter; the
    kernels' checks raise on what they do not take."""
    mel3_tt = tcb.tap_modes(64, True, (True, True))
    assert tcb.slab_plan(mel3_tt, True, 16, (2, 2)) == (
        "mel3_v2", True, False, "conv_block_mel3")
    assert tcb.slab_plan(mel3_tt, True, 4, (1, 2)) == (
        "mel3_v2", False, False, "conv_block_mel3_per_tap")
    assert tcb.slab_plan(mel3_tt, True, 4, (2, 2))[::3] == (
        "v1", "conv_block_mel3_v1")
    mixed = tcb.tap_modes(64, True, (True, False), (False, True))
    assert tcb.slab_plan(mixed, True, 8, (1, 2)) == (
        "mel3_v2", True, True, "conv_block_mel3")
    for key in ("conv_block_mel3", "conv_block_mel3_per_tap",
                "conv_block_mel3_v1"):
        assert key in tcb.launches
    assert {"pair_conv_pool_v1", "pair_conv_pool_conv2_v1"} <= set(
        tpc.launches)
    with pytest.raises(ValueError):
        tcb.check_tri_slab(12, (1, 2), True, False)
    for m in (4, 128):                 # row 5's time pairs in a 128-row tile
        with pytest.raises(ValueError):
            tcb.check_v2_pool(m, (2, 2))
    tcb.check_v2_pool(64, (2, 2))
