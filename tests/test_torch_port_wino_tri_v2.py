"""Row 8's and row 4 tri's second designs, emulated on the CPU in their
own blockings.

The card's kernels cannot run here, so this file repeats their blockings
in PyTorch (``ops/kernels/conv_block_wino.py:block_wino_emulated``,
``ops/kernels/conv_block.py:tri_slab_emulated``) and holds them to the
plain versions:

* the Winograd product kernel folds each ``M_k`` into the output tile as
  it finishes, j outer and i inner (``wino_fold_emulated``), which must
  give ``_output_transform``'s bits, while accumulating the 16 planes in
  k order must not;
* the Winograd scales as maxes of pieces of each group, combined by max
  (``wino_max_kernel``'s ``atomicMax``), equal to the plain ``sv``;
* the Winograd block in the product kernel's blocking (128-tile blocks
  crossing group edges, each row scaled by its own group's ``sv``, the
  products a 64-byte K chunk at a time, the fold): int8 bit for bit
  against ``block_wino_plain``, bf16 within 1e-2, and int8 within
  ``INT8_TOL`` (2e-3 relative RMS, ``tests/test_torch_port_wino.py``'s
  bound: the per-(k, chunk) scales) of the JAX kernel in interpret mode;
* tri's slab form: each tile's slab rows at offset ``dt M`` are the rows
  direct9's per-tap GEMM reads (halo-padded output rows, the mel pad
  columns, groups crossed), and the block in that blocking is
  ``block_plain``'s tri block bit for bit;
* each first design raises on a CPU tensor, and each kernel's shape check
  raises on a shape it does not take.

``chip_smoke.py`` holds the kernels themselves to the plain versions and
to their first designs on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_kernels import _block_case, _rel_rms, _tab
from texttoaudiogrounding_tpu.ops.pallas import conv_block_wino as jw
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block_wino as tw

INT8_TOL, BF16_TOL = 2e-3, 1e-2
# B = 2, M = 8, Cin = Cout = 64, odd T, two chunks: conv1 has 272 tiles in
# groups of 68, conv2 240 in groups of 60, so 128-tile blocks cross groups
WINO_T, WINO_TC, WINO_TPAD = 59, 30, 60


def _torch_case(t, m, cin, cout, seed):
    x, w1, ab1, w2, ab2 = _block_case(t, m, cin, cout, seed=seed)
    return (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w1),
            _tab(ab1), torch.from_numpy(w2), _tab(ab2))


@pytest.fixture(scope="module")
def wino_case():
    return _torch_case(WINO_T, 8, 64, 64, seed=14)


def test_wino_fold_keeps_the_plain_order():
    rng = np.random.default_rng(3)
    # planes of large, nearly cancelling values: the order of additions
    # shows in the last bits
    big = rng.normal(size=(4, 4, 1, 4096)) * 1e4
    mm = [torch.from_numpy(big[k // 4, k % 4] * (1 + rng.normal() * 1e-3)
                           + rng.normal(size=(1, 4096))).float()
          for k in range(16)]
    ref = tw._output_transform([[mm[4 * i + j] for j in range(4)]
                                for i in range(4)])
    got = tw.wino_fold_emulated(mm)
    at = ((1, 1, 1, 0), (0, 1, -1, -1))
    for tau in range(2):
        for mu in range(2):
            assert torch.equal(got[tau][mu], ref[tau][mu])
            naive = torch.zeros_like(mm[0])
            for k in range(16):
                c = at[tau][k // 4] * at[mu][k % 4]
                if c:
                    naive = naive + c * mm[k]
            assert not torch.equal(naive, ref[tau][mu])


@pytest.mark.parametrize("piece", [1, 37, tw.SCALE_PIECE, 10 ** 6])
def test_wino_scales_are_the_plain_maxes(wino_case, piece):
    x = wino_case[0]
    vk = torch.randn(16, 4, 68, 64) * torch.rand(16, 4, 1, 1)
    ref = vk.abs().amax(dim=(2, 3))
    assert torch.equal(tw.wino_scales_emulated(vk, piece), ref)
    # and on a real conv1's V_k: the plain version's sv
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 3, 4))
    win = xp.unfold(1, WINO_TC + 6, WINO_TC).permute(0, 1, 4, 2, 3)
    win = win.reshape(4, WINO_TC + 6, 10, 64)
    nt = WINO_TC // 2 + 2
    d = [[win[:, i:i + 2 * nt - 1:2, j:j + 7:2] for j in range(4)]
         for i in range(4)]
    v = tw.butterfly(d)
    vk = torch.stack([v[k // 4][k % 4].reshape(4, -1, 64)
                      for k in range(16)])
    plain = torch.stack([v[k // 4][k % 4].abs().amax(dim=(1, 2, 3))
                         for k in range(16)])
    assert torch.equal(tw.wino_scales_emulated(vk, piece), plain)


def test_wino_blocks_cross_groups():
    r1, r2 = (WINO_TC // 2 + 2) * 4, WINO_TC // 2 * 4
    for r, p in ((r1, 4 * r1), (r2, 4 * r2)):
        spans = {(p0 // r, (min(p0 + tw.FOLD_BM, p) - 1) // r)
                 for p0 in range(0, p, tw.FOLD_BM)}
        assert any(a != b for a, b in spans)


def test_wino_emulated_int8_is_plain_bit_for_bit(wino_case):
    kw = dict(quantize=True, tc=WINO_TC, tpad=WINO_TPAD)
    ref = tw.block_wino_plain(*wino_case, **kw)
    got = tw.block_wino_emulated(*wino_case, **kw, piece=37)
    assert got.shape == (2, WINO_T // 2, 4, 64)
    assert torch.equal(got, ref)


def test_wino_emulated_bf16(wino_case):
    kw = dict(quantize=False, tc=WINO_TC, tpad=WINO_TPAD)
    ref = tw.block_wino_plain(*wino_case, **kw)
    got = tw.block_wino_emulated(*wino_case, **kw)
    assert _rel_rms(got.float().numpy(), ref.float().numpy()) <= BF16_TOL


def test_wino_emulated_int8_matches_jax():
    t, tc = 19, 10
    x, w1, ab1, w2, ab2 = _block_case(t, 8, 64, 64, seed=5)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jw.fused_block_wino(
        jx, w1, tuple(jnp.asarray(v) for v in ab1), w2,
        tuple(jnp.asarray(v) for v in ab2), quantize=True, tc=tc,
        compute_dtype=jnp.bfloat16, interpret=True), np.float32)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    got = tw.block_wino_emulated(tx, torch.from_numpy(w1), _tab(ab1),
                                 torch.from_numpy(w2), _tab(ab2),
                                 quantize=True, tc=tc, tpad=20)
    assert _rel_rms(got.float().numpy(), ref) <= INT8_TOL


@pytest.mark.parametrize("m", [8, 16])
def test_tri_slab_rows_are_the_per_tap_rows(m):
    g, r_in, mp = 3, 9, m + 2          # 3 groups of tc + 4 = 9 rows
    n_pos = g * r_in * m
    checked = crossed = 0
    for p0 in range(0, n_pos, tcb.SLAB_BM):
        f = tcb.slab_rows(n_pos, m, p0)
        crossed += int(f[0] // (r_in * m) != f[-1] // (r_in * m))
        for k in range(tcb.SLAB_BM):
            p = p0 + k
            if p >= n_pos:
                continue
            gi, rp, mel = p // (r_in * m), (p // m) % r_in, p % m
            if rp in (0, r_in - 1):              # junk rows, not stored
                continue
            for dt in range(3):
                for dm in range(3):
                    src = f[dt * m + k]
                    col = src % m + dm
                    # direct9's tap (dt, dm) of output row rp - 1
                    want = ((gi * r_in + rp - 1) + dt) * mp + mel + dm
                    assert (src // m) * mp + col == want
                    # the taps past either mel edge read a zero pad column
                    assert (col in (0, m + 1)) == (
                        (dm, mel) in ((0, 0), (2, m - 1)))
                    checked += 1
    assert crossed and checked == 9 * g * (r_in - 2) * m


@pytest.mark.parametrize("m", [8, 16])
def test_tri_slab_emulated_is_plain_bit_for_bit(m):
    x, w1, ab1, w2, ab2 = _torch_case(21, m, 64, 64, seed=m)
    modes = tcb.tap_modes(64, True, None, (True, True))
    ref = tcb.block_plain(x, w1, ab1, w2, ab2, (1, 2), quantize=True, tc=6,
                          modes=modes)
    got = tcb.tri_slab_emulated(x, w1, ab1, w2, ab2, (1, 2), quantize=True,
                                tc=6)
    assert torch.equal(got, ref)
    # tri's int8 result is direct9's at the same chunk
    assert torch.equal(got, tcb.block_plain(x, w1, ab1, w2, ab2, (1, 2),
                                            quantize=True, tc=6))


def test_tri_slab_emulated_bf16():
    x, w1, ab1, w2, ab2 = _torch_case(21, 16, 64, 64, seed=2)
    ref = tcb.block_plain(x, w1, ab1, w2, ab2, (1, 2), quantize=False, tc=6,
                          modes=tcb.tap_modes(64, False, None, (True, True)))
    got = tcb.tri_slab_emulated(x, w1, ab1, w2, ab2, (1, 2), quantize=False,
                                tc=6)
    assert _rel_rms(got.float().numpy(), ref.float().numpy()) <= BF16_TOL


def test_first_designs_raise_on_cpu(wino_case):
    x, w1, ab1, w2, ab2 = wino_case
    with pytest.raises(ValueError, match="CUDA"):
        tw._fused_block_wino_v1(x, w1, ab1, w2, ab2, quantize=True,
                                tc=WINO_TC)
    with pytest.raises(ValueError, match="CUDA"):
        tcb._fused_tri_v1(x, w1, ab1, w2, ab2, (1, 2), quantize=True, tc=6)


def test_kernel_shape_checks():
    tw.check_kernel_shape(8, 128, 256)
    for m, cin, cout in ((7, 128, 256), (8, 96, 256), (8, 128, 200)):
        with pytest.raises(ValueError):
            tw.check_kernel_shape(m, cin, cout)
    assert tcb.tri_route(16, (1, 2), True, True) == (True, True,
                                                     "conv_block_tri")
    # time pairs: conv1 on the slab, conv2 on direct9's per-tap GEMM
    assert tcb.tri_route(16, (2, 2), True, True) == (True, False,
                                                     "conv_block_tri")
    assert tcb.tri_route(16, (2, 2), False, True)[2] == \
        "conv_block_tri_per_tap"
    assert tcb.tri_route(4, (1, 2), True, True)[2] == \
        "conv_block_tri_per_tap"
    assert tcb.tri_route(4, (2, 2), True, True)[2] == "conv_block_tri_v1"
    tcb.check_tri_slab(16, (1, 2), True, True)
    for m, pool, s1, s2 in ((4, (1, 2), True, False), (12, (1, 2), True,
                                                       True),
                            (16, (2, 2), False, True)):
        with pytest.raises(ValueError):
            tcb.check_tri_slab(m, pool, s1, s2)
