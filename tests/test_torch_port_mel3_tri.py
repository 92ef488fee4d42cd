"""Row 4's ``mel3`` and ``tri`` tap modes: the port against the JAX kernel.

``fused_double_conv_pool(..., mel3=, tri=)`` (``ops/pallas/conv_block.py:370``):
the same numpy-seeded inputs go through the JAX kernel in interpret mode
(each JAX run made once for the module) and the port's wrapper on the CPU,
which runs its plain PyTorch version.

Tolerances:
* ``compute_dtype=float32``: within 1e-4 (absolute and relative) of the
  JAX kernel, JAX's own bound against its XLA block;
* int8 at equal ``tc``: relative RMS <= 5e-3 (the row-4 bound: a bf16
  rounding of y1 can flip with f32 sums taken in another order; measured
  0 for ``mel3=(True, False)``, <= 7e-4 for ``(True, True)``); the port's
  direct9 (per-clip x scale, f32 y1) must miss it against JAX's mel3, and
  a conv1 scale window one cell short must miss it by 10x;
* int8 ``tri`` is direct9's arithmetic: equal to the port's direct9 bit
  for bit at the same ``tc``;
* bf16: relative RMS <= 1e-2 against the JAX kernel.
The kernels run only on a CUDA card; ``chip_smoke.py`` holds them against
the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_conv_block import CASES
from tests.test_torch_port_kernels import (_bf16, _block_case, _jab,
                                           _rel_rms, _tab, _to_np)
from texttoaudiogrounding_tpu.ops.pallas import conv_block as jcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb

F32_TOL, INT8_TOL, BF16_TOL = 1e-4, 5e-3, 1e-2
TT, TF, FT = (True, True), (True, False), (False, True)
ID = {TT: "TT", TF: "TF", FT: "FT"}
SHAPES = {"16x8": (16, 8, 128, 256), "16x16": (16, 16, 128, 256)}
TC, LOUD_M = 4, 8                     # chunk of the int8 runs; loud case M
# name: (shape or CASES index, pool, quantize, mel3, tri, tc, dtype)
RUNS = {
    **{f"f32_mel3_{i}": (i, None, False, TT, None, None, "f32")
       for i in range(3)},
    **{f"f32_tri_{ID[tri]}": (1, None, False, None, tri, None, "f32")
       for tri in (TT, TF, FT)},
    **{f"int8_mel3_{ID[mel3]}_{s}": (s, (1, 2), True, mel3, None, TC,
                                     "bf16")
       for mel3 in (TF, TT) for s in SHAPES},
    "int8_mel3_default_tc": ("16x16", (1, 2), True, TT, None, None, "bf16"),
    **{f"int8_tri_{ID[tri]}": ("16x8", (1, 2), True, None, tri, TC, "bf16")
       for tri in (TT, TF, FT)},
    **{f"bf16_{name}": ("16x16", (1, 2), False, mel3, tri, TC, "bf16")
       for name, mel3, tri in (("mel3_TT", TT, None), ("mel3_TF", TF, None),
                               ("tri_TT", None, TT))},
    **{f"loud_{ID[mel3]}_{mel}": ((16, LOUD_M, 128, 256), (1, 2), True,
                                  mel3, None, TC, "bf16")
       for mel3 in (TF, TT) for mel in (0, 1)},
}


def _loud(x, mel):
    """Quiet input with a loud cell at (TC + 2, mel): mel 0 is the last
    cell of chunk 0's mel3 scale window, mel 1 lies outside it."""
    x = x * 0.05
    x[:, TC + 2, mel] = 5.0
    return x


def _inputs(name):
    shape, pool, quantize, mel3, tri, tc, dtype = RUNS[name]
    if isinstance(shape, int):
        t, m, cin, cout, pool = CASES[shape]
    else:
        t, m, cin, cout = SHAPES.get(shape, shape)
    x, w1, ab1, w2, ab2 = _block_case(t, m, cin, cout, seed=t * m)
    if name.startswith("loud"):
        x = _loud(x, int(name[-1]))
    if dtype == "f32":
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        jx, tx = _bf16(x)
    return (jx, tx, w1, ab1, w2, ab2, pool,
            dict(quantize=quantize, mel3=mel3, tri=tri, tc=tc))


@pytest.fixture(scope="module")
def jax_out():
    """Every run of the JAX kernel in interpret mode, once."""
    out = {}
    for name in RUNS:
        jx, _, w1, ab1, w2, ab2, pool, kw = _inputs(name)
        dt = jnp.float32 if RUNS[name][-1] == "f32" else jnp.bfloat16
        out[name] = _to_np(jcb.fused_double_conv_pool(
            jx, jnp.asarray(w1), _jab(ab1), jnp.asarray(w2), _jab(ab2),
            pool, compute_dtype=dt, interpret=True, **kw))
    return out


def _port(name, **over):
    _, tx, w1, ab1, w2, ab2, pool, kw = _inputs(name)
    kw = {**kw, **over}
    dt = torch.float32 if RUNS[name][-1] == "f32" else torch.bfloat16
    got = tcb.fused_double_conv_pool(
        tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
        _tab(ab2), pool, compute_dtype=dt, **kw)
    b, t, m, _ = tx.shape
    assert got.shape == (b, t // pool[0], m // pool[1], w1.shape[-1])
    assert got.dtype == (torch.bfloat16 if kw["quantize"] else dt)
    return _to_np(got)


@pytest.mark.parametrize("name", [n for n in RUNS if n.startswith("f32")])
def test_f32_modes_match_pallas(name, jax_out):
    np.testing.assert_allclose(_port(name), jax_out[name], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", [n for n in RUNS
                                  if n.startswith("int8_mel3")])
def test_int8_mel3_matches_pallas(name, jax_out):
    """mel3's own scales meet JAX's; direct9's (per-clip x, f32 y1) at the
    same tc must not."""
    ref = jax_out[name]
    assert _rel_rms(_port(name), ref) <= INT8_TOL
    if RUNS[name][5] is not None:
        control = _port(name, mel3=(False, False))
        assert _rel_rms(control, ref) > INT8_TOL


@pytest.mark.parametrize("mel3", [TF, TT], ids=ID.get)
def test_mel3_window_scale_reaches_one_cell_past(mel3, jax_out):
    """The loud cell at (TC + 2, mel 0) sets chunk 0's conv1 scale in
    both packages; a window one cell short misses chunk 0 by 10x the
    limit; the same cell at mel 1 leaves chunk 0 as the quiet input has
    it."""
    c0 = slice(0, TC)                       # chunk 0's output times
    name0, name1 = f"loud_{ID[mel3]}_0", f"loud_{ID[mel3]}_1"
    got0, ref0 = _port(name0), jax_out[name0]
    assert _rel_rms(got0[:, c0], ref0[:, c0]) <= INT8_TOL
    _, tx, w1, ab1, w2, ab2, pool, _ = _inputs(name0)
    m = LOUD_M
    short = _to_np(tcb.double_conv_plain(
        tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
        _tab(ab2), pool, quantize=True, tc=TC, round_y1=mel3[1],
        x_scale=lambda xf, tc, nch: tcb.window_scale(
            xf, tc, nch, 2 * m + 1, (tc + 4) * m + 1)))
    assert _rel_rms(short[:, c0], ref0[:, c0]) >= 10 * INT8_TOL
    got1 = _port(name1)
    assert _rel_rms(got1[:, c0], jax_out[name1][:, c0]) <= INT8_TOL
    x, *_ = _block_case(16, m, 128, 256, seed=16 * m)
    quiet = tcb.fused_double_conv_pool(
        _bf16(x * 0.05)[1], torch.from_numpy(w1), _tab(ab1),
        torch.from_numpy(w2), _tab(ab2), pool, quantize=True, tc=TC,
        mel3=mel3)
    np.testing.assert_array_equal(got1[:, c0], _to_np(quiet)[:, c0])
    assert not np.array_equal(got0[:, c0], _to_np(quiet)[:, c0])


@pytest.mark.parametrize("tri", [TT, TF, FT], ids=ID.get)
def test_int8_tri_is_direct9(tri, jax_out):
    name = f"int8_tri_{ID[tri]}"
    got = _port(name)
    np.testing.assert_array_equal(got, _port(name, tri=None))
    assert _rel_rms(got, jax_out[name]) <= INT8_TOL


@pytest.mark.parametrize("name", [n for n in RUNS if n.startswith("bf16")])
def test_bf16_modes_match_pallas(name, jax_out):
    assert _rel_rms(_port(name), jax_out[name]) <= BF16_TOL


@pytest.mark.parametrize("mel3,tri", [(FT, None), (TT, TF)],
                         ids=["mel3_FT", "mel3_TT_tri_TF"])
def test_int8_mel3_conv2_after_direct_conv1_raises(mel3, tri):
    x, w1, ab1, w2, ab2 = _block_case(8, 8, 128, 128)
    jx, tx = _bf16(x)
    with pytest.raises(ValueError, match="mel3"):
        jcb.fused_double_conv_pool(jx, jnp.asarray(w1), _jab(ab1),
                                   jnp.asarray(w2), _jab(ab2), (1, 2),
                                   quantize=True, mel3=mel3, tri=tri,
                                   interpret=True)
    with pytest.raises(ValueError, match="mel3"):
        tcb.fused_double_conv_pool(tx, torch.from_numpy(w1), _tab(ab1),
                                   torch.from_numpy(w2), _tab(ab2), (1, 2),
                                   quantize=True, mel3=mel3, tri=tri)


def test_default_rule():
    """``mel3 = (not quantize and cin < 128, False)``, tri clearing it."""
    assert tcb.tap_modes(64, False) == (True, False, False, False)
    assert tcb.tap_modes(64, True) == (False,) * 4
    assert tcb.tap_modes(128, False) == (False,) * 4
    assert tcb.tap_modes(64, False, tri=TF) == (False, False, True, False)
    assert tcb.tap_modes(128, True, TT, FT) == (True, False, False, True)
    # the bf16 default at Cin 64 chunks as mel3 (True, False)
    shape, pool = (2, 500, 32, 64), (2, 2)
    modes = tcb.tap_modes(64, False)
    assert tcb.block_tc(shape, 128, pool, False, modes) == jcb._pick_tc(
        500, 32, 64, 128, 2, 2, False, jnp.bfloat16, (True, False))


FLAGSHIP = {"block3": (250, 16, 128, 256), "block4": (250, 8, 256, 512)}
TC_SHAPES = {**FLAGSHIP, "case0": (20, 32, 64, 128), "case1": (16, 16, 128,
             256), "case2": (12, 8, 256, 512), "loud": (16, 8, 128, 256)}
MODES = [(None, None), (TF, None), (TT, None), (None, TT), (None, TF),
         (None, FT), (FT, None)]


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("shape", list(TC_SHAPES))
def test_chunk_rule_matches_jax(shape, quantize):
    """The wrapper's tc for every mode is JAX's (``conv_block.py:483``,
    Cin padded to 128 for a per-clip int8 input)."""
    t, m, cin, cout = TC_SHAPES[shape]
    pool = (2, 2) if shape == "case0" else (1, 2)
    for mel3, tri in MODES:
        if quantize and mel3 == FT:
            continue
        m1, m2, t1, t2 = tcb.tap_modes(cin, quantize, mel3, tri)
        cin_j = max(cin, 128) if quantize and not m1 else cin
        ref = jcb._pick_tc(t, m, cin_j, cout, *pool, quantize, jnp.bfloat16,
                           (m1 or t1, m2 or t2))
        assert tcb.block_tc((2, t, m, cin), cout, pool, quantize,
                            (m1, m2, t1, t2)) == ref, (mel3, tri)


def test_chunk_rule_at_the_flagship():
    def tc(block, quantize, mel3=None, tri=None):
        t, m, cin, cout = FLAGSHIP[block]
        return tcb.block_tc((32, t, m, cin), cout, (1, 2), quantize,
                            tcb.tap_modes(cin, quantize, mel3, tri))
    assert tc("block3", True) == 125 and tc("block3", True, TT) == 50
    assert tc("block3", True, tri=TT) == 50 and tc("block3", False, TF) == 50
    assert tc("block4", False) == 50 and tc("block4", False, TT) == 10
    assert tc("block4", True, TT) == 50
