"""Row 12's second design (``csrc/bn_pool_v2.cu``) on the CPU.

The kernels run only on a CUDA card; ``chip_smoke.py`` holds them there
against the plain versions and the backward's first design.  Here their
orders of summation are held through the emulations of
``ops/kernels/bn_pool.py``, inputs made with numpy from a seed:

* ``bn_pool_bwd_emulated`` (each thread's windows in turn, the CTA's thread
  rows in a tree, the CTAs' partial sums as the last CTA adds them, ``ac·dz``
  rounded to x's type) against ``bn_pool_bwd_plain``: dx within 1e-4
  relative RMS, dγ and dβ within 1e-5, in f32 and bf16, at pt = 2 and 1,
  with an odd T (a row that floor pooling drops) and at grids of one CTA,
  of a few, and of more CTAs than window rows;
* the same emulation against ``jax.vjp`` of the JAX ``bn_relu_dual_pool``
  in interpret mode, on the same numpy inputs, at
  ``tests/test_torch_port_pool.py``'s tolerances (f32 2e-4, bf16 2e-2);
* with its ``ac·dz`` rounding switched off, the bf16 emulation misses the
  plain dx by at least 10x the 1e-4 limit: the rounding point is held;
* ``batch_stats_emulated`` (eight rows a thread in a tree, then the same
  CTA trees) against plain ``batch_stats``, the f64 statistics and JAX's
  mean and var: var within 1e-4 relative, mean within 1e-5 of the
  channel's std, at zero-mean inputs and at mean 3, std 0.5, where E[x²] −
  mean² cancels.  There JAX's own f32 var (XLA's reduction on the CPU)
  lies up to 1.3e-4 from the f64 value at block 1's geometry, so the
  emulation is held to the f64 value, and JAX to it within 2e-4 (var) and
  1e-5 std (mean);
* the wrappers on CPU tensors: the plain versions, either design, no
  launch, and ``ValueError`` for a design or a shape the kernels refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.ops.pallas.bn_pool import bn_relu_dual_pool
from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool

# (T, M, C, pool): block 2-like, odd T, pool (1, 2), block 1's M = C = 64
# with an odd T, and block 4's C = 512 at pool (1, 2)
GEOMETRIES = [(8, 8, 128, (2, 2)), (9, 8, 128, (2, 2)), (8, 4, 256, (1, 2)),
              (9, 64, 64, (2, 2)), (8, 4, 512, (1, 2))]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
JAX_TOL = {"f32": 2e-4, "bf16": 2e-2}
B = 2


def _rel(got, ref) -> float:
    d = (got.double() - ref.double())
    return float(torch.sqrt((d ** 2).mean() / (ref.double() ** 2).mean()))


def _case(t, m, c, pool, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, t, m, c)).astype(np.float32)
    x[:, :2] = np.round(x[:, :2] * 2) / 2      # ties in the windows
    g = rng.normal(size=(B, t // pool[0], m // 2, c)).astype(np.float32)
    gamma = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=c) * 0.1).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    tg = torch.from_numpy(g).to(dtype)
    mean, var = bn_pool.batch_stats_plain(tx)
    inv = torch.rsqrt(var + 1e-5)
    return (x, g, gamma, beta), (tx, tg, mean, inv, torch.from_numpy(gamma),
                                 torch.from_numpy(beta))


def _grids(rows: int) -> list:
    """(grid, rows a CTA): one CTA, three, and more CTAs than rows."""
    return [(1, rows), (3, -(-rows // 3)), (rows + 3, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,m,c,pool", GEOMETRIES)
def test_bwd_emulation_matches_the_plain_backward(t, m, c, pool, dtype):
    _, args = _case(t, m, c, pool, DTYPES[dtype])
    ref = bn_pool.bn_pool_bwd_plain(*args, pool)
    for grid, rpc in _grids(B * (t // pool[0])):
        dx, dgamma, dbeta = bn_pool.bn_pool_bwd_emulated(*args, pool, grid,
                                                         rpc)
        assert dx.dtype == args[0].dtype and dx.shape == args[0].shape
        assert _rel(dx, ref[0]) <= 1e-4, (grid, rpc)
        assert _rel(dgamma, ref[1]) <= 1e-5, (grid, rpc)
        assert _rel(dbeta, ref[2]) <= 1e-5, (grid, rpc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,m,c,pool", [GEOMETRIES[1], GEOMETRIES[2],
                                        GEOMETRIES[3]])
def test_bwd_emulation_matches_jax(t, m, c, pool, dtype):
    (x, g, gamma, beta), _ = _case(t, m, c, pool, DTYPES[dtype], seed=1)
    xj = jnp.asarray(x, JAX_DTYPES[dtype])

    def jop(v, s, b):
        out, mean, var = bn_relu_dual_pool(v, s, b, pool=pool, interpret=True)
        return out, (mean, var)

    _, vjp, (jmean, jvar) = jax.vjp(jop, xj, jnp.asarray(gamma),
                                    jnp.asarray(beta), has_aux=True)
    ref = vjp(jnp.asarray(g, JAX_DTYPES[dtype]))
    tx = torch.from_numpy(x).to(DTYPES[dtype])
    mean = torch.tensor(np.asarray(jmean, np.float32))
    inv = torch.rsqrt(torch.tensor(np.asarray(jvar, np.float32)) + 1e-5)
    rows = B * (t // pool[0])
    got = bn_pool.bn_pool_bwd_emulated(
        tx, torch.from_numpy(g).to(DTYPES[dtype]), mean, inv,
        torch.from_numpy(gamma), torch.from_numpy(beta), pool, 3,
        -(-rows // 3))
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(r, np.float32),
            rtol=JAX_TOL[dtype], atol=JAX_TOL[dtype], err_msg=name)


@pytest.mark.parametrize("t,m,c,pool", GEOMETRIES[1:4])
def test_the_rounding_point_of_ac_dz_is_held(t, m, c, pool):
    _, args = _case(t, m, c, pool, torch.bfloat16, seed=2)
    ref = bn_pool.bn_pool_bwd_plain(*args, pool)[0]
    rows = B * (t // pool[0])
    kept = bn_pool.bn_pool_bwd_emulated(*args, pool, 2, -(-rows // 2))[0]
    lost = bn_pool.bn_pool_bwd_emulated(*args, pool, 2, -(-rows // 2),
                                        rounding=False)[0]
    assert _rel(kept, ref) <= 1e-4
    assert _rel(lost, ref) >= 10 * 1e-4


def _stats_gap(got, ref) -> tuple:
    """(var relative error, mean error over std), worst channel."""
    (gm, gv), (rm, rv) = ((torch.as_tensor(np.asarray(a, np.float64))
                           for a in pair) for pair in (got, ref))
    return (float(((gv - rv).abs() / rv).max()),
            float(((gm - rm).abs() / rv.sqrt()).max()))


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,m,c,pool", [GEOMETRIES[1], GEOMETRIES[3],
                                        GEOMETRIES[4]])
def test_stats_emulation_matches_plain_and_jax(t, m, c, pool, dtype, shift):
    (x, _, gamma, beta), _ = _case(t, m, c, pool, DTYPES[dtype], seed=3)
    if shift:
        x = x * 0.5 + 3.0
    tx = torch.from_numpy(x).to(DTYPES[dtype])
    plain = bn_pool.batch_stats_plain(tx)
    _, jmean, jvar = bn_relu_dual_pool(jnp.asarray(x, JAX_DTYPES[dtype]),
                                       jnp.asarray(gamma), jnp.asarray(beta),
                                       pool=pool, interpret=True)
    xd = tx.double()
    exact = (xd.mean(dim=(0, 1, 2)),
             (xd * xd).mean(dim=(0, 1, 2)) - xd.mean(dim=(0, 1, 2)) ** 2)
    refs = [plain, exact]
    if shift:
        # JAX's own f32 var drifts from the f64 value where E[x²] − mean²
        # cancels; held here so that a regression in the reference shows
        jax_var, jax_mean = _stats_gap((jmean, jvar), exact)
        assert jax_var <= 2e-4 and jax_mean <= 1e-5, (jax_var, jax_mean)
    else:
        refs.append((jmean, jvar))
    for grid, rpc in _grids(B * t * m):
        got = bn_pool.batch_stats_emulated(tx, grid, rpc)
        for ref in refs:
            var_rel, mean_std = _stats_gap(got, ref)
            assert var_rel <= 1e-4, (grid, rpc, var_rel)
            assert mean_std <= 1e-5, (grid, rpc, mean_std)


def test_tree_and_part_orders_sum_everything():
    part = torch.arange(1.0, 1.0 + 7 * 24).reshape(7, 24)
    for n in (1, 2, 3, 5, 7):
        assert torch.equal(bn_pool._tree(part[:n]), part[:n].sum(0))
    for nt in (8, 24, 512):
        assert torch.equal(bn_pool._sum_parts(part, nt), part.sum(0))


def test_wrappers_run_the_plain_versions_on_cpu():
    t, m, c, pool = GEOMETRIES[1]
    _, args = _case(t, m, c, pool, torch.float32, seed=4)
    before = dict(bn_pool.launches)
    ref = bn_pool.bn_pool_bwd_plain(*args, pool)
    for design in bn_pool.DESIGNS:
        got = bn_pool.bn_pool_bwd(*args, pool, design=design)
        assert all(torch.equal(a, r) for a, r in zip(got, ref))
    stats = bn_pool.batch_stats(args[0])
    assert all(torch.equal(a, r) for a, r in
               zip(stats, bn_pool.batch_stats_plain(args[0])))
    assert bn_pool.launches == before
    with pytest.raises(ValueError):
        bn_pool.bn_pool_bwd(*args, pool, design="one_pass")
    with pytest.raises(ValueError):
        bn_pool.batch_stats(args[0][0])
    with pytest.raises(ValueError):
        bn_pool.bn_pool_bwd_emulated(*args, pool, 1, 1)
