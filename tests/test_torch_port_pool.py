"""The port's pool kernels' plain versions against the JAX package.

``texttoaudiogrounding_tpu_torch/ops/kernels/dual_pool.py`` and
``bn_pool.py`` hold the plain PyTorch versions of the CUDA kernels
(``csrc/dual_pool.cu``, ``csrc/bn_pool.cu``); for CPU tensors the wrappers
run them.  The same numpy inputs go through the JAX kernels in interpret
mode and the port, at every geometry of ``tests/test_pallas_dual_pool.py``
(block-1 packed layout, odd T, pool (1, 2), several chunks), with ties in
the pool windows and exact zeros forced.  Tolerances (absolute and
relative):

* f32: forward 1e-6; gradients 1e-5 (``dual_pool_relu``) and 2e-4
  (``bn_relu_dual_pool``, the JAX tests' own); batch statistics 1e-6;
* bf16 inputs: forward within one bf16 ulp of the JAX output, gradients
  2e-2 (``tests/test_pallas_bn_pool.py:78-91``);
* the autograd functions against torch autograd through the plain chain
  (``F.avg_pool2d + F.max_pool2d`` after ReLU / batch-statistics BN): the
  f32 tolerances above;
* a train-mode ``ConvBlock`` with ``bn_pool`` / ``pool_vjp`` at the block
  geometries of ``tests/test_pallas_bn_pool.py:94-98`` and block 4,
  against the JAX ``ConvBlock`` under ``TTG_BN_POOL`` / ``TTG_POOL_VJP``
  and ``TTG_PALLAS_INTERPRET=1``: loss rtol 1e-5, gradients rtol 1e-4 /
  atol 1e-5 of their scale, running statistics 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu.models.layers import ConvBlock as JConvBlock
from texttoaudiogrounding_tpu.ops.pallas.bn_pool import bn_relu_dual_pool
from texttoaudiogrounding_tpu.ops.pallas.dual_pool import dual_pool_relu
from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock
from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool, dual_pool

GEOMETRIES = [
    (8, 8, 128, (2, 2)),
    (9, 8, 128, (2, 2)),     # odd T: floor pooling, zero grad on the tail
    (8, 4, 256, (1, 2)),
    (8, 8, 512, (1, 2)),     # block-4-like
    (16, 8, 128, (2, 2)),    # several TPU chunks (tc=8)
    (8, 64, 64, (2, 2)),     # block 1 (packed lanes on the TPU)
    (9, 64, 64, (2, 2)),     # block 1, odd T
]


def _input(t, m, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, m, c)).astype(np.float32)
    x[:, :2] = np.round(x[:, :2] * 2) / 2      # ties in the windows
    x[0, 0, 0, :] = 0.0                         # relu(0)
    return rng, x


def _tc(t):
    return 8 if t == 16 else None


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _bf16_ulp_close(got, ref, what):
    """|got - ref| within one bf16 ulp of ref (bf16 values as f32)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    bad = np.abs(got - ref) > ulp
    assert not bad.any(), (what, got[bad][:5], ref[bad][:5])


@pytest.mark.parametrize("t,m,c,pool", GEOMETRIES)
def test_dual_pool_plain_matches_jax(t, m, c, pool):
    rng, x = _input(t, m, c)
    ref, vjp = jax.vjp(lambda v: dual_pool_relu(v, pool, _tc(t), True),
                       jnp.asarray(x))
    g = rng.normal(size=ref.shape).astype(np.float32)
    (ref_dx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    out = dual_pool.dual_pool_relu(tx, pool)
    out.backward(torch.from_numpy(g))
    _close(out.detach(), ref, 1e-6, "forward")
    _close(tx.grad, ref_dx, 1e-5, "dx")
    assert not tx.grad[:, t // pool[0] * pool[0]:].any()   # tail rows


@pytest.mark.parametrize("t,m,c,pool", [GEOMETRIES[0], GEOMETRIES[3],
                                        GEOMETRIES[6]])
def test_dual_pool_plain_bf16_matches_jax(t, m, c, pool):
    rng, x = _input(t, m, c, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref, vjp = jax.vjp(lambda v: dual_pool_relu(v, pool, None, True), xb)
    g = rng.normal(size=ref.shape).astype(np.float32)
    (ref_dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = dual_pool.dual_pool_relu(tx, pool)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert out.dtype == tx.grad.dtype == torch.bfloat16
    _bf16_ulp_close(out.detach().float(), ref, "forward")
    _close(tx.grad.float(), ref_dx, 2e-2, "dx")


def _scale_bias(rng, c):
    scale = (rng.normal(size=c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    return scale, bias


@pytest.mark.parametrize("t,m,c,pool", GEOMETRIES)
def test_bn_pool_plain_matches_jax(t, m, c, pool):
    rng, x = _input(t, m, c)
    scale, bias = _scale_bias(rng, c)

    def jop(v, s, b):
        out, mean, var = bn_relu_dual_pool(v, s, b, pool=pool, tc=_tc(t),
                                           interpret=True)
        return out, (mean, var)

    ref, vjp, (jmean, jvar) = jax.vjp(jop, jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), has_aux=True)
    g = rng.normal(size=ref.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    out, mean, var = bn_pool.bn_relu_dual_pool(*leaves, pool)
    out.backward(torch.from_numpy(g))
    _close(out.detach(), ref, 1e-6, "forward")
    _close(mean, jmean, 1e-6, "mean")
    _close(var, jvar, 1e-6, "var")
    for name, leaf, rg in zip(("dx", "dscale", "dbias"), leaves, ref_grads):
        _close(leaf.grad, rg, 2e-4, name)


@pytest.mark.parametrize("t,m,c,pool", [GEOMETRIES[2], GEOMETRIES[6]])
def test_bn_pool_plain_bf16_matches_jax(t, m, c, pool):
    rng, x = _input(t, m, c, seed=2)
    scale, bias = _scale_bias(rng, c)
    xb = jnp.asarray(x, jnp.bfloat16)

    def jop(v, s, b):
        return bn_relu_dual_pool(v, s, b, pool=pool, interpret=True)[0]

    ref, vjp = jax.vjp(jop, xb, jnp.asarray(scale), jnp.asarray(bias))
    g = rng.normal(size=ref.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(g, jnp.bfloat16))
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (scale, bias)]
    out = bn_pool.bn_relu_dual_pool(*leaves, pool)[0]
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert out.dtype == leaves[0].grad.dtype == torch.bfloat16
    _bf16_ulp_close(out.detach().float(), ref, "forward")
    for name, leaf, rg in zip(("dx", "dscale", "dbias"), leaves, ref_grads):
        _close(leaf.grad.float(), rg, 2e-2, name)


def _torch_chain(x, pool, bn=None):
    """ReLU (after batch-statistics BN when ``bn = (scale, bias)``) and
    torch's own avg + max pools, channel-last."""
    if bn is not None:
        mean = x.mean(dim=(0, 1, 2))
        var = torch.clamp_min((x * x).mean(dim=(0, 1, 2)) - mean * mean, 0.0)
        x = (x - mean) * (torch.rsqrt(var + 1e-5) * bn[0]) + bn[1]
    y = torch.relu(x).permute(0, 3, 1, 2)
    return (F.avg_pool2d(y, pool) + F.max_pool2d(y, pool)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("with_bn", [False, True])
@pytest.mark.parametrize("t,m,c,pool", [GEOMETRIES[1], GEOMETRIES[2],
                                        GEOMETRIES[6]])
def test_autograd_functions_match_torch_autograd(t, m, c, pool, with_bn):
    rng, x = _input(t, m, c, seed=3)
    scale, bias = _scale_bias(rng, c)
    g = None
    grads = []
    for use_kernel in (True, False):
        leaves = [torch.from_numpy(a.copy()).requires_grad_()
                  for a in (x, scale, bias)]
        if use_kernel and with_bn:
            out = bn_pool.bn_relu_dual_pool(*leaves, pool)[0]
        elif use_kernel:
            out = dual_pool.dual_pool_relu(leaves[0], pool)
        else:
            out = _torch_chain(leaves[0], pool,
                               leaves[1:] if with_bn else None)
        if g is None:
            g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
        out.backward(g)
        grads.append((out.detach(), [v.grad for v in leaves]))
    (out_k, gk), (out_t, gt) = grads
    _close(out_k, out_t, 1e-6, "forward")
    for name, a, b in zip(("dx", "dscale", "dbias"), gk, gt):
        if not with_bn and name != "dx":
            continue
        _close(a, b, 2e-4 if with_bn else 1e-5, name)


BLOCKS = [
    (12, 64, 1, 64, (2, 2)),      # block 1
    (8, 8, 64, 128, (2, 2)),      # block 2
    (8, 4, 128, 256, (1, 2)),     # block 3
    (6, 8, 256, 512, (1, 2)),     # block 4
]


def _port_block(cin, cout, params, stats, **opts):
    block = ConvBlock(cin, cout, **opts)
    with torch.no_grad():
        for conv in ("conv1", "conv2"):
            getattr(block, conv).weight.copy_(torch.from_numpy(
                np.array(params[conv]["kernel"]).transpose(3, 2, 0, 1)))
        for bn in ("bn1", "bn2"):
            mod = getattr(block, bn)
            mod.weight.copy_(torch.from_numpy(np.array(params[bn]["scale"])))
            mod.bias.copy_(torch.from_numpy(np.array(params[bn]["bias"])))
            mod.running_mean.copy_(torch.from_numpy(
                np.array(stats[bn]["mean"])))
            mod.running_var.copy_(torch.from_numpy(
                np.array(stats[bn]["var"])))
    return block.train()


@pytest.mark.parametrize("route", ["bn_pool", "pool_vjp"])
@pytest.mark.parametrize("t,m,cin,cout,pool", BLOCKS)
def test_conv_block_pool_routes_match_jax(t, m, cin, cout, pool, route,
                                          monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, t, m, cin)).astype(np.float32)
    jblock = JConvBlock(cout)
    var = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x), bn_train=False)
    params = var["params"]
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        var["batch_stats"])
    monkeypatch.setenv("TTG_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TTG_BN_POOL" if route == "bn_pool" else
                       "TTG_POOL_VJP", str(cout))

    def jloss(p):
        out, mut = jblock.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(x), bn_train=True,
                                pool_size=pool, mutable=["batch_stats"])
        return jnp.sum(out ** 2) * 1e-3, mut["batch_stats"]

    (jl, jstats), jg = jax.value_and_grad(jloss, has_aux=True)(params)

    block = _port_block(cin, cout, params, stats, **{route: True})
    launched = {**dual_pool.launches, **bn_pool.launches}
    out = block(torch.from_numpy(x), pool)
    loss = (out ** 2).sum() * 1e-3
    loss.backward()
    assert {**dual_pool.launches, **bn_pool.launches} == launched  # CPU
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    for conv in ("conv1", "conv2"):
        ref = np.asarray(jg[conv]["kernel"]).transpose(3, 2, 0, 1)
        got = getattr(block, conv).weight.grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=conv)
    for bn in ("bn1", "bn2"):
        mod = getattr(block, bn)
        for name, got in (("scale", mod.weight.grad),
                          ("bias", mod.bias.grad)):
            ref = np.asarray(jg[bn][name])
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=f"{bn}.{name}")
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(jstats[bn]["mean"]), atol=1e-6)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(jstats[bn]["var"]), atol=1e-6)


def test_pool_routes_follow_the_jax_gate(monkeypatch):
    x = torch.zeros(1, 4, 6, 96)
    assert not ConvBlock._pool_kernel_ok(x, (2, 2))          # C = 96
    assert not ConvBlock._pool_kernel_ok(torch.zeros(1, 4, 5, 128), (2, 2))
    assert not ConvBlock._pool_kernel_ok(torch.zeros(1, 1, 4, 128), (2, 2))
    assert not ConvBlock._pool_kernel_ok(torch.zeros(1, 4, 4, 128), (2, 1))
    assert not ConvBlock._pool_kernel_ok(torch.zeros(1, 4, 64, 64), (1, 2))
    assert ConvBlock._pool_kernel_ok(torch.zeros(1, 4, 64, 64), (2, 2))
    # a prime T, which the TPU chunk picker turns down, runs the kernel
    assert ConvBlock._pool_kernel_ok(torch.zeros(1, 13, 4, 256), (1, 2))
    # bn_pool only in train mode; pool_vjp in eval too; bn_pool wins
    block = ConvBlock(4, 128, bn_pool=True, pool_vjp=True)
    calls = []
    for mod, name in ((bn_pool, "bn_relu_dual_pool"),
                      (dual_pool, "dual_pool_relu")):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            "texttoaudiogrounding_tpu_torch.models.layers." + name,
            lambda *a, _n=name, _o=orig: calls.append(_n) or _o(*a))
    xin = torch.randn(2, 4, 4, 4)
    block.train()(xin)
    block.eval()(xin)
    assert calls == ["bn_relu_dual_pool", "dual_pool_relu"]
