"""The hoisted GRU walks' second design (``csrc/gru_walk_sm90.cu``) on the CPU.

The kernel runs only on a CUDA card; ``chip_smoke.py`` holds it there
against the plain walks and the first design.  Here its orders of
summation are held through ``gru_walk_cluster_emulated`` (the rows in
``groups`` batch groups, the units over ``ctas`` CTAs, the gate products by
8 K slices in order, the dh chain by CTA slices in pairs: v2 one K = 3H sum,
v3 three K = H sums added in gate order), inputs made with numpy from a
seed:

* against ``gru_walk_plain``: rtol 1e-5, atol 1e-5 at T = 9 and B = 5, 13
  and 32 at small H, also with an odd number of units a CTA (H = 30 on 2
  CTAs of 15) and one CTA a unit pair short of the cluster (3 CTAs);
* against ``jax.grad`` of ``bigru_pallas_trainable_v2`` / ``_v3``
  (interpret mode), the emulation standing in for the walk of the port's
  ``BiGRUFunction``: rtol 2e-4, atol 2e-5, as ``test_torch_port_gru.py``;
* v2 against v3: their dproj differ in at least one element (the orders
  differ) and agree to rtol 1e-5, atol 1e-5;
* ``walk_plan`` on the served shape and its ``ValueError`` on shapes the
  kernel cannot take, and ``gru_walk``'s ``design=`` and counters on the
  CPU (the plain walk, no launch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.ops.pallas.gru import (
    bigru_pallas_trainable_v2,
    bigru_pallas_trainable_v3,
)
from texttoaudiogrounding_tpu_torch.ops.kernels import gru

T = 9
# (B, H, ctas, groups)
SHAPES = [(5, 8, 1, 1), (5, 30, 2, 1), (13, 16, 2, 2), (13, 24, 3, 2),
          (32, 32, 4, 3), (32, 16, 16, 4)]
JAX_FN = {"v2": bigru_pallas_trainable_v2, "v3": bigru_pallas_trainable_v3}
JAX_B, JAX_H = 5, 30


def _case(seed, b, h, t=T):
    rng = np.random.default_rng(seed)
    proj = (rng.normal(size=(t, 2 * b, 3 * h)) * 0.5).astype(np.float32)
    wh = (rng.normal(size=(2, h, 3 * h)) * 0.3).astype(np.float32)
    bn = (rng.normal(size=(2, h)) * 0.2).astype(np.float32)
    gy = rng.normal(size=(t, 2 * b, h)).astype(np.float32)
    return proj, wh, bn, gy


def _walk_args(seed, b, h):
    proj, wh, bn, gy = (torch.from_numpy(a) for a in _case(seed, b, h))
    return proj, gru.gru_forward(proj, wh, bn), gy, wh, bn


@pytest.mark.parametrize("b,h,ctas,groups", SHAPES)
@pytest.mark.parametrize("variant", gru.VARIANTS)
def test_walk_emulation_matches_the_plain_walk(variant, b, h, ctas, groups):
    args = _walk_args(51, b, h)
    got = gru.gru_walk_cluster_emulated(*args, variant, ctas=ctas,
                                        groups=groups)
    ref = gru.gru_walk_plain(*args, variant == "v3")
    for name, a, r in zip(("dproj", "drznn"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


_JAX_CACHE = {}


def _jax_grads(variant):
    """``jax.grad`` of the JAX kernel ``variant`` in interpret mode, made
    once per variant."""
    if variant not in _JAX_CACHE:
        proj, wh, bn, gy = _case(53, JAX_B, JAX_H)
        fn = JAX_FN[variant]

        def loss(p, w, c):
            return jnp.sum(fn(p, w, c, interpret=True) * gy)

        grads = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (proj, wh, bn)))
        _JAX_CACHE[variant] = [np.asarray(g) for g in grads]
    return _JAX_CACHE[variant]


@pytest.mark.parametrize("ctas,groups", [(2, 1), (6, 2), (3, 5)])
@pytest.mark.parametrize("variant", gru.VARIANTS)
def test_walk_emulation_matches_the_jax_kernel(variant, ctas, groups,
                                               monkeypatch):
    def emulated_walk(proj, ys, gy, wh, bn, v, design="cluster"):
        return gru.gru_walk_cluster_emulated(proj, ys, gy, wh, bn, v,
                                             ctas=ctas, groups=groups)

    monkeypatch.setattr(gru, "gru_walk", emulated_walk)
    proj, wh, bn, gy = _case(53, JAX_B, JAX_H)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (proj, wh, bn)]
    ys = gru.bigru_trainable(*leaves, variant=variant)
    (ys * torch.from_numpy(gy)).sum().backward()
    for name, x, ref in zip(("dproj", "dwh", "dbn"), leaves,
                            _jax_grads(variant)):
        np.testing.assert_allclose(x.grad.numpy(), ref, rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("b,h,ctas,groups", [(5, 30, 2, 1), (32, 32, 4, 3)])
def test_v2_and_v3_emulations_sum_in_different_orders(b, h, ctas, groups):
    args = _walk_args(55, b, h)
    v2, v3 = (gru.gru_walk_cluster_emulated(*args, v, ctas=ctas,
                                            groups=groups)
              for v in gru.VARIANTS)
    assert not torch.equal(v2[0], v3[0])
    for a, r in zip(v2, v3):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_walk_plan_fits_the_served_shape():
    plan = gru.walk_plan(32, 256)
    assert plan == {"ctas": 16, "units": 16, "groups": 3, "rows": 11,
                    "smem": 208656}
    assert gru.walk_plan(13, 256)["groups"] == 2
    assert gru.walk_plan(5, 30) == {"ctas": 2, "units": 15, "groups": 1,
                                    "rows": 5, "smem": 66256}
    small = gru.walk_plan(1, 4)
    assert (small["ctas"], small["units"], small["groups"],
            small["rows"]) == (1, 4, 1, 1)


@pytest.mark.parametrize("b,h", [(32, 272), (32, 512), (32, 34), (0, 32),
                                 (4, 0)])
def test_walk_plan_raises_on_a_shape_it_cannot_take(b, h):
    with pytest.raises(ValueError):
        gru.walk_plan(b, h)


def test_walk_plan_raises_past_the_cards_shared_memory(monkeypatch):
    need = gru.walk_plan(32, 256)["smem"]
    monkeypatch.setattr(gru, "_SMEM_MAX", need - 1)
    with pytest.raises(ValueError, match="shared memory"):
        gru.walk_plan(32, 256)
    assert gru.walk_plan(1, 4)["smem"] < need


def test_walk_designs_and_counters_on_the_cpu():
    args = _walk_args(57, 5, 8)
    before = dict(gru.launches)
    for variant in gru.VARIANTS:
        ref = gru.gru_walk_plain(*args, variant == "v3")
        for design in gru.DESIGNS:
            got = gru.gru_walk(*args, variant, design=design)
            for a, r in zip(got, ref):
                assert torch.equal(a, r)   # CPU tensors: the plain walk
        assert f"gru_bwd_{variant}_per_step" in gru.launches
    assert gru.launches == before           # which launches no kernel
    with pytest.raises(ValueError, match="design"):
        gru.gru_walk(*args, "v2", design="grid")
    with pytest.raises(ValueError, match="variant"):
        gru.gru_walk_cluster_emulated(*args, "v4", ctas=1, groups=1)
    for ctas in (4, 1):         # 4 does not divide H; 1 CTA of 30 units
        with pytest.raises(ValueError):
            gru.gru_walk_cluster_emulated(*_walk_args(57, 5, 30)[:5], "v2",
                                          ctas=ctas, groups=1)
    with pytest.raises(ValueError):
        gru.gru_walk_cluster_emulated(*args, "v2", ctas=3, groups=1)
