"""The GRU backward's second design (``csrc/gru_bwd_sm90.cu``) on the CPU.

The kernel runs only on a CUDA card; ``chip_smoke.py`` holds it there
against the plain version and the first design.  Here its orders of
summation are held through ``gru_backward_cluster_emulated`` (the units
split over ``ctas`` CTAs whose partial dh are added in CTA order, the rows
over ``groups`` batch groups whose dWh / dbn are added in group order, the
gate products by K slices of 32), at T = 7, B = 4, H = 32, inputs made
with numpy from a seed:

* against ``gru_backward_plain``: rtol 1e-5, atol 1e-5 in f32 and in bf16
  (``test_torch_port_gru.py``'s bf16 tolerance; f32 sums in other orders);
* against ``jax.grad`` of ``bigru_pallas_trainable`` (interpret mode):
  rtol 2e-4, atol 2e-5, as ``test_torch_port_gru.py``;
* against ``jax.grad`` of ``bigru_pallas_trainable_bf16``: at T = 2, 3
  and 4 rtol 1e-5, atol 1e-5 (``test_torch_port_gru.py``'s bf16
  tolerance; measured at most 4.8e-7 apart), the T = 2 walk also at rtol
  1e-5, atol 1e-6, which the same walk on f32 operands misses.  At T = 7
  one dcol value rounds to the other bf16 neighbour: its f32 sum differs
  in the last bit between XLA and PyTorch, in ``gru_backward_plain`` as
  in the emulation, whatever the plan (both lie 4.6e-4 apart from JAX at
  most, 2.1e-2 relative on the worst element), and the walk carries the
  flip on.  So T = 7 is held by relative RMS of each gradient within
  ``B16_FLIP_TOL`` = 2e-3, ``chip_smoke.py``'s ``GRU_B16_TOL`` for the
  same reason at T = 250, and within 1e-5 of ``gru_backward_plain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.ops.pallas.gru import (
    bigru_pallas_trainable,
    bigru_pallas_trainable_bf16,
)
from texttoaudiogrounding_tpu_torch.ops.kernels import gru

T, B, H = 7, 4, 32
PLANS = [(1, 1), (2, 2), (4, 4), (2, 3)]       # (ctas, groups)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_FN = {"f32": bigru_pallas_trainable, "bf16": bigru_pallas_trainable_bf16}
# (dtype, T, rtol, atol) held element-wise against the JAX kernel
JAX_CASES = [("f32", T, 2e-4, 2e-5), ("bf16", 2, 1e-5, 1e-5),
             ("bf16", 3, 1e-5, 1e-5), ("bf16", 4, 1e-5, 1e-5)]
B16_FLIP_TOL = 2e-3


def _case(seed, t=T):
    rng = np.random.default_rng(seed)
    proj = (rng.normal(size=(t, 2 * B, 3 * H)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(2, H, 3 * H)) * 0.3).astype(np.float32)
    bn = (rng.normal(size=(2, H)) * 0.2).astype(np.float32)
    gy = rng.normal(size=(t, 2 * B, H)).astype(np.float32)
    return proj, wh, bn, gy


_JAX_CACHE = {}


def _jax_reference(dtype: str, t: int):
    """(ys, (dproj, dwh, dbn)) of the JAX kernel in interpret mode, made
    once per dtype and length."""
    if (dtype, t) not in _JAX_CACHE:
        proj, wh, bn, gy = _case(31, t)
        fn = JAX_FN[dtype]

        def loss(p, w, c):
            return jnp.sum(fn(p, w, c, interpret=True) * gy)

        args = [jnp.asarray(a) for a in (proj, wh, bn)]
        ys = np.asarray(fn(*args, interpret=True))
        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
        _JAX_CACHE[(dtype, t)] = ys, [np.asarray(g) for g in grads]
    return _JAX_CACHE[(dtype, t)]


def _emulate(dtype: str, t: int, ctas: int, groups: int):
    proj, wh, bn, gy = (torch.from_numpy(a) for a in _case(31, t))
    ys = gru.gru_forward(proj, wh, bn, DTYPES[dtype])
    return (proj, ys, gy, wh, bn), gru.gru_backward_cluster_emulated(
        proj, ys, gy, wh, bn, DTYPES[dtype], ctas=ctas, groups=groups)


@pytest.mark.parametrize("ctas,groups", PLANS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_emulation_matches_the_plain_backward(dtype, ctas, groups):
    args, got = _emulate(dtype, T, ctas, groups)
    ref = gru.gru_backward_plain(*args, DTYPES[dtype])
    for name, a, r in zip(("dproj", "dwh", "dbn"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ctas,groups", PLANS)
@pytest.mark.parametrize("dtype,t,rtol,atol", JAX_CASES)
def test_cluster_emulation_matches_the_jax_kernel(dtype, t, rtol, atol,
                                                  ctas, groups):
    ref_ys, ref_grads = _jax_reference(dtype, t)
    (_, ys, *_), got = _emulate(dtype, t, ctas, groups)
    np.testing.assert_allclose(ys.numpy(), ref_ys, rtol=rtol, atol=atol)
    for name, a, r in zip(("dproj", "dwh", "dbn"), got, ref_grads):
        np.testing.assert_allclose(a.numpy(), r, rtol=rtol, atol=atol,
                                   err_msg=name)


def _rel_rms(a, r):
    return float(np.sqrt(np.mean((a - r) ** 2) / np.mean(r ** 2)))


@pytest.mark.parametrize("ctas,groups", PLANS)
def test_bf16_cluster_emulation_matches_the_jax_kernel_through_a_flip(
        ctas, groups):
    _, ref_grads = _jax_reference("bf16", T)
    args, got = _emulate("bf16", T, ctas, groups)
    plain = gru.gru_backward_plain(*args, torch.bfloat16)
    for name, a, r, p in zip(("dproj", "dwh", "dbn"), got, ref_grads, plain):
        assert _rel_rms(a.numpy(), r) <= B16_FLIP_TOL, name
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("ctas,groups", [(2, 2), (4, 1)])
def test_bf16_cluster_emulation_at_two_steps_is_tight(ctas, groups):
    _, ref_grads = _jax_reference("bf16", 2)
    args, got = _emulate("bf16", 2, ctas, groups)
    for name, a, r in zip(("dproj", "dwh", "dbn"), got, ref_grads):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the same walk on f32 operands misses by far more than that
    f32 = gru.gru_backward_cluster_emulated(*args, ctas=ctas, groups=groups)
    assert float(np.abs(f32[1].numpy() - ref_grads[1]).max()) > 1e-4


def test_cluster_orders_differ_from_the_plain_sums():
    # the emulation really sums in other orders: two plans differ in bits
    _, one = _emulate("f32", T, 1, 1)
    _, many = _emulate("f32", T, 4, 4)
    assert any(not torch.equal(a, b) for a, b in zip(one, many))


def test_cluster_plan_fits_the_served_shape():
    plan = gru.cluster_plan(32, 256)
    assert plan == {"ctas": 16, "units": 16, "groups": 3, "rows": 11,
                    "smem": plan["smem"]}
    assert plan["smem"] <= 227 * 1024
    assert gru.cluster_plan(32, 256, torch.bfloat16) == plan
    # ragged groups and the smallest shapes
    plan = gru.cluster_plan(26, 40)
    assert plan == {"ctas": 4, "units": 10, "groups": 3, "rows": 9,
                    "smem": plan["smem"]}
    small = gru.cluster_plan(1, 4)
    assert (small["ctas"], small["units"], small["groups"],
            small["rows"]) == (1, 4, 1, 1)


@pytest.mark.parametrize("b,h,dtype", [(32, 272, torch.float32),
                                       (32, 34, torch.float32),
                                       (0, 32, torch.float32),
                                       (32, 256, torch.float16)])
def test_cluster_plan_raises_on_a_shape_it_cannot_take(b, h, dtype):
    with pytest.raises(ValueError):
        gru.cluster_plan(b, h, dtype)


def test_backward_designs_and_counters_on_the_cpu():
    proj, wh, bn, gy = (torch.from_numpy(a) for a in _case(37))
    ys = gru.gru_forward(proj, wh, bn)
    before = dict(gru.launches)
    ref = gru.gru_backward_plain(proj, ys, gy, wh, bn)
    for design in gru.DESIGNS:
        got = gru.gru_backward(proj, ys, gy, wh, bn, design=design)
        for a, r in zip(got, ref):
            assert torch.equal(a, r)       # CPU tensors: the plain version
    assert gru.launches == before           # which launches no kernel
    for name in ("gru_bwd", "gru_bwd_bf16", "gru_bwd_per_step",
                 "gru_bwd_bf16_per_step"):
        assert name in gru.launches
    with pytest.raises(ValueError, match="design"):
        gru.gru_backward(proj, ys, gy, wh, bn, design="v1")
    with pytest.raises(ValueError):
        gru.gru_backward_cluster_emulated(proj, ys, gy, wh, bn, ctas=3,
                                          groups=1)
