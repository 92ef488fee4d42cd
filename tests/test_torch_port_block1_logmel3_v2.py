"""The second designs of rows 7 (``csrc/block1_small_v2.cu``) and 9
(``csrc/logmel_v3_v2.cu``), emulated on the CPU in their own blocking, and
the route that sends the v2 GEMM's unsupported time-pair shapes of rows 3,
4 direct9, 5 and 6 to their first designs.

The card's kernels cannot run here, so this file repeats their blocking in
PyTorch and holds the result to the plain versions; the plain versions are
held to the JAX kernels by ``tests/test_torch_port_block12.py`` (row 7) and
``tests/test_torch_port_logmel_variants.py`` (row 9), so no JAX kernel runs
here.

Row 7, PANNs block 1 from the log-mel:

* conv1 straight from the bf16 log-mel (no im2col), by blocks of at most
  16 rows of one (clip, chunk) group split evenly (and half its mels,
  which changes no value), the nine bf16 products
  summed in tap order in f32, the affine, the ReLU, rows outside the clip
  zero;
* int8: a max pass over each group's rows by blocks, combined by max
  (``atomicMax``), then the rows recomputed and quantized with the group's
  scale into the mel-padded ``[G, tc + 2, 66, 64]`` layout;
* conv2 as the implicit GEMM of ``tests/test_torch_port_conv_igemm.py``
  (tiles of 128 rows, the time-pair row permutation) and its f32 pool at
  BN = Cout = 64.

Row 9, log-mel v3: the interior frames' A rows read from the bf16 copy of
the waveform at ``t 320 - 512``; the bf16 power's band-limited projection
on the bf16 filterbank; the edge frames as a direct f32 DFT of
reflect-indexed samples on the f32 basis, against the plain frontend's
edge frames.

Tolerances: int8 bit for bit against the plain version; bf16 1e-2
relative RMS; conv1's f32 rows bit for bit against the im2col form; the
edge frames within 2e-3 dB of ``_edge_frames`` (f32 sums in another
order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_port_block1_logmel_v2 import band_mel, full_mel
from tests.test_torch_port_conv_igemm import BM, conv2_pool, igemm, tile_perm
from texttoaudiogrounding_tpu_torch.ops import frontend as tfront
from texttoaudiogrounding_tpu_torch.ops.kernels import block1_small as tb1s
from texttoaudiogrounding_tpu_torch.ops.kernels import block2_small as tb2s
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block_pair as tb2
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel as tlm
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel_v3 as tv3
from texttoaudiogrounding_tpu_torch.ops.kernels import pair_conv_pool as tpc

MELS = 64
TT = 16            # largest row count of a conv1 block (conv1_kernel)
CFG = tfront.cnn8rnn_mel_config(32000)


def _rel_rms(got, ref):
    got, ref = got.double(), ref.double()
    return float(torch.sqrt(torch.mean((got - ref) ** 2)
                            / torch.mean(ref ** 2)))


# ------------------------------------------------------------- the route

ROUTED = {"row 3": tb2, "row 4 direct9": tcb, "row 5": tpc, "row 6": tb2s}


@pytest.mark.parametrize("row", sorted(ROUTED))
@pytest.mark.parametrize("m,second", [(4, False), (24, False), (32, True)])
def test_route_by_shape(row, m, second):
    """At pool (2, 2) each row's wrapper asks the one shape rule: M 4 and
    24 run the first design, M 32 the second."""
    assert ROUTED[row].v2_takes is tcb.v2_takes
    assert tcb.v2_takes(m, (2, 2)) is second
    assert tcb.v2_takes(m, (1, 2))        # mel pairs alone: any M


def test_route_counters_are_the_first_designs():
    assert "conv_block_v1" in tcb.launches
    assert {"pair_conv_pool_v1", "pair_conv_pool_conv2_v1"} <= set(
        tpc.launches)
    assert set(tb2s.launches) == {"block2_small", "block2_small_v1"}
    assert isinstance(tb2.launches_v1, int)


# ------------------------------------------------------ row 7: block 1

@pytest.fixture(scope="module")
def b1_case():
    """One clip of 37 frames: tc 16 gives 3 chunks, the last ragged (time
    36 in it, 37-47 past the clip), and an odd trailing frame."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 37, MELS)).astype(
        np.float32)).to(torch.bfloat16)
    w1 = torch.from_numpy((rng.normal(size=(3, 3, 1, 64)) * 0.3).astype(
        np.float32))
    w2 = torch.from_numpy((rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(
        np.float32))
    ab = [(torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)),
           torch.from_numpy((rng.normal(size=64) * 0.1).astype(np.float32)))
          for _ in range(2)]
    return x, w1, ab[0], w2, ab[1]


def conv1_rows(x, b: int, t0: int, rows: int, w1k, a1, b1) -> torch.Tensor:
    """``conv1_kernel``'s rows at times ``t0 .. t0 + rows`` of clip b,
    ``[rows, M, 64]`` f32: the staged log-mel tile (times t0 - 1 .., mels
    -1 .. M, zero outside the clip), the nine products in tap order dt *
    3 + dm, each sum and the affine rounded in f32, the ReLU, zero
    outside the clip."""
    t, m = x.shape[1:]
    tile = torch.zeros(rows + 2, m + 2)
    lo, hi = max(t0 - 1, 0), min(t0 + rows + 1, t)
    if lo < hi:
        tile[lo - (t0 - 1):hi - (t0 - 1), 1:-1] = x[b, lo:hi].float()
    w = w1k.float()
    acc = None
    for k in range(9):
        term = tile[k // 3:k // 3 + rows, k % 3:k % 3 + m, None] * w[k]
        acc = term if acc is None else acc + term
    y = torch.relu(acc * a1 + b1)
    time = t0 + torch.arange(rows)
    return torch.where(((time >= 0) & (time < t))[:, None, None], y, 0.0)


def row_blocks(r: int) -> list:
    """``launch_conv1``'s blocks: (first row, rows) of R rows split into
    the fewest blocks of at most TT rows, as evenly as they go."""
    nb = -(-r // TT)
    rpb = -(-r // nb)
    return [(r0, min(rpb, r - r0)) for r0 in range(0, r, rpb)]


def emulate_block1_small(x, w1, ab1, w2, ab2, *, quantize: bool, tc: int,
                         info: dict | None = None):
    """The second design of row 7 on ``x [B, T, M]`` bf16, M 8, 16, 32 or
    64."""
    b, t, m = x.shape
    w1k, a1, b1, w2k, a2, b2 = tb1s.prepare(w1, ab1, w2, ab2, quantize)
    nch = -(-t // tc)
    r = tc + 2
    y1 = torch.zeros(b * nch, r, m + 2, 64,
                     dtype=torch.int8 if quantize else torch.bfloat16)
    ymax = torch.zeros(b * nch)
    for g in range(b * nch):
        bi, j = divmod(g, nch)
        rows_of = {r0: conv1_rows(x, bi, j * tc - 1 + r0, n, w1k, a1, b1)
                   for r0, n in row_blocks(r)}
        if quantize:
            for y in rows_of.values():                  # OUT_MAX
                ymax[g] = torch.maximum(ymax[g], y.max())
            sy = tcb.over127(torch.clamp(ymax[g], min=1e-6))
            for r0, y in rows_of.items():               # OUT_Q8
                y1[g, r0:r0 + y.shape[0], 1:-1] = tcb._quant_i8(y, 1.0 / sy)
        else:                                           # OUT_BF16
            for r0, y in rows_of.items():
                y1[g, r0:r0 + y.shape[0], 1:-1] = y.to(torch.bfloat16)
    tiles = []
    acc2 = igemm(y1, w2k, tc, tiles, tile_perm(m, True))
    if info is not None:
        info.update(y1=y1, tiles=tiles, ymax=ymax)
    gscale = tcb.over127(torch.clamp(ymax, min=1e-6)) if quantize else None
    return conv2_pool(acc2, a2, b2, gscale, b, nch, tc, t, m, (2, 2),
                      tiles)


def test_row7_conv1_without_im2col_equals_the_im2col_form(b1_case):
    """The direct conv1 from the log-mel equals ``_conv1`` over
    ``conv1_im2col`` bit for bit: the im2col's columns were only a layout
    of the same nine bf16 values a cell."""
    x, w1, ab1, w2, ab2 = b1_case
    t = x.shape[1]
    w1k, a1, b1 = tb1s.prepare(w1, ab1, w2, ab2, True)[:3]
    ref = tb1s._conv1(tb1s.conv1_im2col(x, t), w1.to(torch.bfloat16), t)
    got = torch.cat([conv1_rows(x, 0, r0, n, w1k, a1, b1)
                     for r0, n in row_blocks(t)])
    assert torch.equal(got, torch.relu(ref[0] * a1 + b1))


def test_row7_conv1_blocks_split_rows_evenly():
    assert row_blocks(50) == [(0, 13), (13, 13), (26, 13), (39, 11)]
    assert row_blocks(18) == [(0, 9), (9, 9)]
    assert row_blocks(4) == [(0, 4)]


def test_row7_int8_emulation_equals_plain(b1_case):
    """int8 bit for bit against ``block1_small_plain``: the max pass over
    f32 rows (out-of-clip rows zero), the quantize pass into the padded
    layout (zero pad columns), conv2 in 128-row tiles of one time pair,
    the ragged last chunk's rows past the clip dropped."""
    x, w1, ab1, w2, ab2 = b1_case
    info = {}
    got = emulate_block1_small(x, w1, ab1, w2, ab2, quantize=True, tc=16,
                               info=info)
    ref = tb1s.block1_small_plain(x, w1, ab1, w2, ab2, quantize=True, tc=16)
    assert got.shape == (1, 18, 32, 64) and torch.equal(got, ref)
    y1 = info["y1"]
    assert not y1[:, :, 0].any() and not y1[:, :, -1].any()
    assert y1[2, 5].any() and not y1[2, 6:].any()   # times 37-48: past T
    # at M = 64 and an even tc a tile is one time pair of one group
    rows = 16 * MELS
    assert all(p0 // rows == (end - 1) // rows and end - p0 == BM
               for p0, end, _ in info["tiles"])


def test_row7_bf16_emulation_close_to_plain(b1_case):
    x, w1, ab1, w2, ab2 = b1_case
    got = emulate_block1_small(x, w1, ab1, w2, ab2, quantize=False, tc=16)
    ref = tb1s.block1_small_plain(x, w1, ab1, w2, ab2, quantize=False,
                                  tc=16)
    assert _rel_rms(got.float(), ref.float()) <= 1e-2


# ----------------------------------------------------- row 9: log-mel v3

@pytest.fixture(scope="module")
def wave():
    """Two clips of 0.5 s: 51 frames, 47 interior ([2, 49)), so the one
    128-row tile holds both clips' interior frames and 34 rows past them."""
    return torch.from_numpy((np.random.default_rng(9).normal(
        size=(2, 16000)) * 0.1).astype(np.float32))


def test_row9_a_rows_read_the_bf16_copy_in_place(wave):
    """Tile row r's A row: interior frame p = 128 i + r of the call, clip
    p // NI, time t_lo + p % NI, 1024 samples from ``t 320 - 512`` of that
    clip's bf16 copy (``wave_cast_kernel``), rows past the last frame
    reading it again; each equals the plain version's frame (``unfold`` of
    the zero-padded cast), the 16-byte pieces are aligned and every row
    lies inside its clip's ``npad``."""
    b, n = wave.shape
    t_lo, t_hi = tv3.edges(n, CFG)
    ni = t_hi - t_lo
    npad = tv3.npad_v3(t_hi, CFG)
    xb = torch.zeros(b, npad)
    xb[:, :min(n, npad)] = wave[:, :npad].to(torch.bfloat16).float()
    tiles = -(-b * ni // 128)
    p = torch.arange(128 * tiles).clamp(max=b * ni - 1)
    clip, t = p // ni, t_lo + p % ni
    start = t * 320 - 512
    assert tiles == 1 and int(start.min()) >= 0 and (2 * start % 16 == 0).all()
    assert int(start.max()) + 1024 <= npad and npad % 8 == 0
    rows = xb[clip[:, None], start[:, None] + torch.arange(1024)]
    ref = F.pad(wave.to(torch.bfloat16).float(), (512, 512)).unfold(
        1, 1024, 320)[:, t_lo:t_hi]
    assert torch.equal(rows[:b * ni], ref.reshape(b * ni, 1024))
    assert torch.equal(rows[b * ni:], rows[b * ni - 1].expand(
        128 * tiles - b * ni, -1))


def test_row9_bf16_band_projection_equals_the_full_one():
    """The bf16 filterbank's band-limited sums (nonzero weights only, in
    ascending bins) equal the full ascending projection on the bf16
    filterbank bit for bit, for a power rounded to bf16."""
    _, band16, w16 = tv3.tables(CFG, torch.device("cpu"))[:3]
    fb16 = tv3._fb_bf16(CFG, torch.device("cpu")).float().numpy()
    rng = np.random.default_rng(0)
    power = torch.from_numpy(
        (rng.standard_exponential((8, fb16.shape[0])) * 10.0 ** rng.uniform(
            -6, 2, (8, 1))).astype(np.float32)).to(torch.bfloat16).float()
    assert torch.equal(band_mel(power, band16.numpy(), w16.numpy()),
                       full_mel(power, fb16))


def emulate_edge_frames(wave) -> torch.Tensor:
    """``edge_frames``: each clip's frames ``t < t_lo`` and ``t >= t_hi``
    as the f32 DFT of the reflect-indexed samples ``t 320 - 512 + k`` on
    the windowed f32 basis over the bins ``[lo, hi)``, summed in k order,
    the f32 power, each mel's band in ascending bins, dB.  Returns ``[B,
    4, 64]`` (left frames, then right)."""
    b, n = wave.shape
    t = tfront.num_frames(n, 320)
    t_lo, t_hi = tv3.edges(n, CFG)
    _, _, _, eb, band, w, (lo, hi) = tv3.tables(CFG, torch.device("cpu"))
    ts = torch.tensor(list(range(t_lo)) + list(range(t_hi, t)))
    s = ts[:, None] * 320 - 512 + torch.arange(1024)
    s = torch.where(s < 0, -s, torch.where(s >= n, 2 * (n - 1) - s, s))
    frames = wave[:, s]                                   # [B, E, 1024]
    re = torch.zeros(b, len(ts), hi - lo)
    im = torch.zeros_like(re)
    for k in range(1024):
        re = re + frames[..., k, None] * eb[k, lo:hi, 0]
        im = im + frames[..., k, None] * eb[k, lo:hi, 1]
    power = torch.zeros(b * len(ts), 512)
    power[:, lo:hi] = (re * re + im * im).reshape(-1, hi - lo)
    mel = band_mel(power, band.numpy(), w.numpy())
    return (tlm._DB * torch.log(torch.clamp(mel, min=1e-10))).reshape(
        b, len(ts), 64)


def test_row9_edge_frames_as_direct_f32_dft(wave):
    """Within 2e-3 dB of ``_edge_frames`` (the plain frontend on the JAX
    package's waveform slices): the same f32 centred-reflect frames of the
    whole clip, summed in another order."""
    n = wave.shape[1]
    t_lo, t_hi = tv3.edges(n, CFG)
    left, right = tv3._edge_frames(wave, CFG, t_lo, t_hi)
    got = emulate_edge_frames(wave)
    ref = torch.cat([left, right], dim=1)
    assert got.shape == ref.shape == (2, 4, 64)
    assert float((got - ref).abs().max()) <= 2e-3


def test_row9_tables_cover_every_band():
    basis, band16, w16, eb, band, w, (lo, hi) = tv3.tables(
        CFG, torch.device("cpu"))
    real, imag, _ = tlm._trimmed_basis(CFG)
    assert eb.shape == (1024, 512, 2)
    assert torch.equal(eb[..., 0], torch.from_numpy(real))
    assert torch.equal(eb[..., 1], torch.from_numpy(imag))
    for bd in (band, band16):
        used = bd[bd[:, 1] > bd[:, 0]]
        assert int(used[:, 0].min()) == lo and int(used[:, 1].max()) == hi
    assert hi - lo <= 512 and w.numel() == w16.numel()


# -------------------------------------------------------------- raises

def test_first_designs_raise_on_cpu(b1_case, wave):
    with pytest.raises(ValueError):
        tb1s._fused_block1_v1(*b1_case, tc=16)
    with pytest.raises(ValueError):
        tv3._fused_log_mel_spectrogram_v3_v1(wave, CFG)
