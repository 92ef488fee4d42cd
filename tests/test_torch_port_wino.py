"""The port's Winograd F(2x2, 3x3) block against the JAX kernel.

``fused_block_wino`` (``ops/pallas/conv_block_wino.py:264``): the same
numpy-seeded inputs go through the JAX kernel in interpret mode (run once
for the module) and the port's wrapper on the CPU, which runs its plain
PyTorch version, at the JAX tests' shapes (``tests/
test_pallas_conv_block_wino.py``): T x M in {20 x 8, 19 x 8 (odd T), 12 x
16} at 128 -> 128 and 8 x 8 at 128 -> 256, with several chunks.

Tolerances:
* ``compute_dtype=float32``: within 2e-4 (absolute and relative) of the
  JAX kernel and of an XLA block (``lax.conv``), JAX's own bound;
* int8 at equal ``tc``: relative RMS <= 2e-3 against the JAX kernel (the
  per-(k, chunk) scales of V_k; measured 2.5e-4, the bf16 rounding of y1
  flipping with f32 sums taken in another order), and < 0.05 against the
  f32 XLA block;
* bf16: relative RMS <= 1e-2 against the JAX kernel.
The kernels run only on a CUDA card; ``chip_smoke.py`` holds them against
the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_conv_block_small import _case, xla_ref
from tests.test_torch_port_kernels import _rel_rms, _to_np
from texttoaudiogrounding_tpu.ops.pallas import conv_block_wino as jw
from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block_wino as tw

F32_TOL, INT8_TOL, BF16_TOL = 2e-4, 2e-3, 1e-2
MODES = {"f32": (False, jnp.float32, torch.float32),
         "int8": (True, jnp.bfloat16, torch.bfloat16),
         "bf16": (False, jnp.bfloat16, torch.bfloat16)}
# (t, m, cin, cout, tc); tc None: the JAX package's pick
CASES = {"20x8": (20, 8, 128, 128, 4), "19x8": (19, 8, 128, 128, 4),
         "12x16": (12, 16, 128, 128, 6), "8x8_expand": (8, 8, 128, 256, 8),
         "20x8_default_tc": (20, 8, 128, 128, None)}
RUNS = [(c, mode) for c in CASES for mode in MODES
        if mode != "bf16" or c in ("12x16", "8x8_expand")]


def _inputs(case, mode):
    t, m, cin, cout, tc = CASES[case]
    x, w1, ab1, w2, ab2 = _case(t, m, cin, cout)
    jx = jnp.asarray(x, MODES[mode][1])
    tx = torch.from_numpy(np.array(jx, np.float32)).to(MODES[mode][2])
    return jx, tx, w1, ab1, w2, ab2, tc


@pytest.fixture(scope="module")
def jax_out():
    """The JAX kernel in interpret mode and the f32 XLA block, per run."""
    out = {}
    for case, mode in RUNS:
        jx, _, w1, ab1, w2, ab2, tc = _inputs(case, mode)
        quantize, jdt, _ = MODES[mode]
        out[case, mode] = (
            np.asarray(jw.fused_block_wino(
                jx, w1, ab1, w2, ab2, quantize=quantize, tc=tc,
                compute_dtype=jdt, interpret=True), np.float32),
            np.asarray(xla_ref(jnp.asarray(jx, jnp.float32),
                               jnp.asarray(w1), ab1, jnp.asarray(w2), ab2)))
    return out


def _tab(ab):
    return tuple(torch.from_numpy(np.asarray(v)) for v in ab)


@pytest.mark.parametrize("case,mode", RUNS)
def test_wino_matches_pallas(case, mode, jax_out):
    _, tx, w1, ab1, w2, ab2, tc = _inputs(case, mode)
    quantize, _, tdt = MODES[mode]
    got = tw.fused_block_wino(tx, torch.from_numpy(w1), _tab(ab1),
                              torch.from_numpy(w2), _tab(ab2),
                              quantize=quantize, tc=tc, compute_dtype=tdt)
    t, m, _, cout, _ = CASES[case]
    assert got.shape == (2, t // 2, m // 2, cout)
    assert got.dtype == (torch.bfloat16 if quantize else tdt)
    ref, f32 = jax_out[case, mode]
    got = _to_np(got)
    if mode == "f32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got, f32, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert _rel_rms(got, ref) <= (INT8_TOL if quantize else BF16_TOL)
        assert _rel_rms(got, f32) < 0.05


def test_winograd_math_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 8, 5)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 5, 7)) * 0.2).astype(np.float32)
    np.testing.assert_allclose(
        tw.transform_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jw.transform_weights(jnp.asarray(w))), rtol=1e-6,
        atol=1e-7)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tw.winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,quantize", [
    ((250, 16, 128, 256), True), ((125, 8, 256, 512), True),
    ((250, 16, 128, 256), False), ((125, 8, 256, 512), False),
    ((20, 8, 128, 128), True), ((37, 8, 128, 256), True)])
def test_chunk_pick_matches_jax(shape, quantize):
    try:
        ref = jw._pick_tpad_tc(*shape, quantize, jnp.bfloat16)
    except ValueError:
        ref = None
    if ref is None:
        with pytest.raises(ValueError):
            tw.pick_tpad_tc(*shape, quantize, torch.bfloat16)
    else:
        assert tw.pick_tpad_tc(*shape, quantize, torch.bfloat16) == ref


def test_conv_block_routes_as_jax():
    """``ConvBlock(wino=True)`` sends what passes the JAX gate to the
    Winograd block and the rest to direct9; the two differ."""
    torch.manual_seed(0)
    blk = ConvBlock(128, 256, conv_mode="int8", wino=True).eval()
    direct = ConvBlock(128, 256, conv_mode="int8").eval()
    direct.load_state_dict(blk.state_dict())
    x = torch.randn(2, 20, 8, 128).to(torch.bfloat16)
    w1 = blk.conv1.weight.detach().permute(2, 3, 1, 0)
    w2 = blk.conv2.weight.detach().permute(2, 3, 1, 0)
    ab1, ab2 = (tcb.fold_bn(bn.weight, bn.bias, bn.running_mean,
                            bn.running_var, bn.eps)
                for bn in (blk.bn1, blk.bn2))
    with torch.no_grad():
        got = blk(x, (2, 2))
        torch.testing.assert_close(got, tw.fused_block_wino(
            x, w1, ab1, w2, ab2, quantize=True), rtol=0, atol=0)
        assert not torch.equal(got, direct(x, (2, 2)))
        # pool (1, 2) and Cin 64 stay on the direct kernels
        torch.testing.assert_close(blk(x, (1, 2)), direct(x, (1, 2)),
                                   rtol=0, atol=0)
    assert tw.routes((2, 20, 8, 128), 256, (2, 2), True)
    assert not tw.routes((2, 20, 8, 64), 256, (2, 2), True)
    assert not tw.routes((2, 20, 7, 128), 256, (2, 2), True)
    assert not tw.routes((2, 125, 8, 256), 512, (2, 2), False)   # JAX raises


def test_wino_rejects_bad_chunks():
    x = torch.zeros(1, 10, 8, 128, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 128, 128)
    ab = (torch.ones(128), torch.zeros(128))
    for tc in (3, 4, 0):           # odd, not dividing T, empty
        with pytest.raises(ValueError):
            tw.fused_block_wino(x, w, ab, w, ab, tc=tc)
    with pytest.raises(ValueError):
        tw.fused_block_wino(x[:, :, :7], w, ab, w, ab, tc=2)
