"""The GRU forward's second design (``csrc/gru_fwd_sm90.cu``) on the CPU.

The kernel runs only on a CUDA card; ``chip_smoke.py`` holds it there
against the plain version, the first design and ``torch.nn.GRU``.  Here its
order of summation is held through ``gru_forward_cluster_emulated`` (the
rows in ``groups`` batch groups, the units over ``ctas`` CTAs, each step's
gate product summed over 8 K slices of ``ceil(H / 8)`` in order), inputs
made with numpy from a seed:

* against ``gru_forward_plain``: rtol 1e-5, atol 1e-6 with the f32 carry
  (f32 sums in another order; measured at most 1.8e-7 apart), rtol 1e-5,
  atol 1e-5 with the bf16 carry (``test_torch_port_gru.py``'s bf16
  tolerance), at T = 7 and B = 1, a ragged B = 13 (two groups of 7 and 6)
  and B = 4, H = 8, 16 and 32, and an odd number of units a CTA (B = 5,
  H = 30 on 2 CTAs of 15);
* against the JAX kernel ``bigru_pallas`` in interpret mode, with both
  carries: rtol 2e-4, atol 2e-5 with the f32 carry
  (``test_torch_port_gru.py``'s), and the same with the bf16 carry;
* ``forward_plan`` on the served shape, B = 13, B = 128, the smallest and
  shapes with an odd number of units a CTA (which the bf16 carry's
  ``mma.sync`` epilogue must not store past), and its ``ValueError`` on
  shapes the kernel cannot take;
* ``gru_forward``'s ``design=`` and its counters on the CPU (the plain
  version, no launch).

``BiGRU``'s kernel route, which takes the cluster design by default, is
held to its grouped loop by ``test_torch_port_gru.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.ops.pallas.gru import bigru_pallas
from texttoaudiogrounding_tpu_torch.ops.kernels import gru

T = 7
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (B, H, ctas, groups)
SHAPES = [(1, 8, 1, 1), (4, 32, 2, 1), (4, 32, 4, 4), (13, 16, 1, 2),
          (13, 16, 2, 3), (5, 8, 8, 5), (5, 30, 2, 1)]
PLAIN_TOL = {"f32": (1e-5, 1e-6), "bf16": (1e-5, 1e-5)}


def _case(seed, b, h, t=T):
    rng = np.random.default_rng(seed)
    proj = (rng.normal(size=(t, 2 * b, 3 * h)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(2, h, 3 * h)) * 0.3).astype(np.float32)
    bn = (rng.normal(size=(2, h)) * 0.2).astype(np.float32)
    return proj, wh, bn


@pytest.mark.parametrize("b,h,ctas,groups", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_forward_emulation_matches_the_plain_forward(dtype, b, h,
                                                             ctas, groups):
    proj, wh, bn = (torch.from_numpy(a) for a in _case(41, b, h))
    dt = DTYPES[dtype][0]
    got = gru.gru_forward_cluster_emulated(proj, wh, bn, dt, ctas=ctas,
                                           groups=groups)
    ref = gru.gru_forward_plain(proj, wh, bn, dt)
    assert got.shape == ref.shape == (T, 2 * b, h)
    rtol, atol = PLAIN_TOL[dtype]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("b,h,ctas,groups", [(4, 32, 2, 2), (13, 16, 1, 2),
                                             (1, 8, 1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_forward_emulation_matches_the_jax_kernel(dtype, b, h, ctas,
                                                          groups):
    proj, wh, bn = _case(43, b, h)
    ref = np.asarray(bigru_pallas(jnp.asarray(proj), jnp.asarray(wh),
                                  jnp.asarray(bn), dtype=DTYPES[dtype][1],
                                  interpret=True))
    got = gru.gru_forward_cluster_emulated(
        *(torch.from_numpy(a) for a in (proj, wh, bn)), DTYPES[dtype][0],
        ctas=ctas, groups=groups)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


def test_cluster_forward_orders_differ_from_the_plain_sums():
    # the emulation really sums in another order than one product a step
    proj, wh, bn = (torch.from_numpy(a) for a in _case(47, 4, 32))
    got = gru.gru_forward_cluster_emulated(proj, wh, bn, ctas=2, groups=1)
    assert not torch.equal(got, gru.gru_forward_plain(proj, wh, bn))


def test_forward_plan_fits_the_served_shapes():
    plan = gru.forward_plan(32, 256)
    assert plan == {"ctas": 16, "units": 16, "groups": 3, "rows": 11,
                    "smem": 92176}
    assert gru.forward_plan(32, 256, torch.bfloat16) == plan
    # a ragged B crosses a group boundary; B = 128 runs in waves
    ragged = gru.forward_plan(13, 256)
    assert (ragged["groups"], ragged["rows"]) == (2, 7)
    wide = gru.forward_plan(128, 256)
    assert (wide["groups"], wide["rows"]) == (11, 12)
    small = gru.forward_plan(1, 4)
    assert (small["ctas"], small["units"], small["groups"],
            small["rows"]) == (1, 4, 1, 1)
    assert gru.forward_plan(26, 40)["ctas"] == 4


@pytest.mark.parametrize("h,ctas", [(30, 2), (60, 4), (120, 8), (15, 1)])
def test_forward_plan_takes_an_odd_number_of_units(h, ctas):
    for dtype in (torch.float32, torch.bfloat16):
        plan = gru.forward_plan(5, h, dtype)
        assert (plan["ctas"], plan["units"], plan["groups"],
                plan["rows"]) == (ctas, 15, 1, 5)


@pytest.mark.parametrize("b,h,dtype", [(32, 272, torch.float32),
                                       (32, 34, torch.float32),
                                       (0, 32, torch.float32),
                                       (32, 0, torch.float32),
                                       (32, 256, torch.float16)])
def test_forward_plan_raises_on_a_shape_it_cannot_take(b, h, dtype):
    with pytest.raises(ValueError):
        gru.forward_plan(b, h, dtype)


def test_forward_designs_and_counters_on_the_cpu():
    proj, wh, bn = (torch.from_numpy(a) for a in _case(53, 3, 8))
    before = dict(gru.launches)
    for dtype in (torch.float32, torch.bfloat16):
        ref = gru.gru_forward_plain(proj, wh, bn, dtype)
        for design in gru.DESIGNS:
            got = gru.gru_forward(proj, wh, bn, dtype, design=design)
            assert torch.equal(got, ref)     # CPU tensors: the plain version
    assert gru.launches == before           # which launches no kernel
    for name in ("gru_fwd", "gru_fwd_bf16", "gru_fwd_per_step",
                 "gru_fwd_bf16_per_step"):
        assert name in gru.launches
    with pytest.raises(ValueError, match="design"):
        gru.gru_forward(proj, wh, bn, design="v1")
    with pytest.raises(ValueError):
        gru.gru_forward_cluster_emulated(proj, wh, bn, ctas=3, groups=1)
    with pytest.raises(ValueError):
        gru.gru_forward_cluster_emulated(proj, wh, bn, ctas=1, groups=4)
