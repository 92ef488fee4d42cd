"""Train-mode BatchNorm → ReLU → avg + max pool: ``csrc/bn_pool.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/bn_pool.py:376
bn_relu_dual_pool``.  The batch statistics of ``x [B, T, M, C]`` (f32 or
bf16, channel-last) are f32 ``E[x²] − E[x]²``, clipped at 0, over (B, T,
M), taken with plain reductions (as the JAX wrapper takes them from XLA).

* Forward, one kernel pass: ``h = relu(x·sc + sh)`` in f32 (``sc = γ
  rsqrt(var + eps)``, ``sh = β − mean·sc``), then the dual pool of
  ``dual_pool.py`` (window = stride = ``(pt, 2)``, floor pooling), rounded
  once to x's type.
* Backward: one pass recomputes ``n = (x − mean)·inv`` and ``h = relu(n γ
  + β)``, routes the window gradients (first maximal element in window
  order, zero at relu(0)), writes ``ac·dz`` (``ac = γ·inv``) in x's type
  and the sums ``s1 = Σdz``, ``s2 = Σdz·n``; then the closed-form train-BN
  correction ``dx = ac·dz − ac·s1/N − n·ac·s2/N`` with ``N = B·T·M`` over
  the full T, ``dγ = s2``, ``dβ = s1`` (``bn_pool.py:343-368``).  On the
  card all of it is one call of the C entry point (three launches: the
  pass, a fixed-order reduction of its per-block partial sums, the
  correction), counted once.

Each wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.ops.kernels import _build
from texttoaudiogrounding_tpu_torch.ops.kernels.dual_pool import (
    check,
    check_channels,
    kernel_ready,
    pool_windows,
    route,
    unwindows,
    windows,
)

launches = {"bn_pool_fwd": 0, "bn_pool_bwd": 0}

_THREADS = 256     # threads of the route pass's blocks (csrc/bn_pool.cu)
_ITER = 16         # windows each thread row takes in the route pass


def batch_stats(x: torch.Tensor) -> tuple:
    """f32 ``(mean, var)`` over (B, T, M), flax's fast variance."""
    xf = x.float()
    mean = xf.mean(dim=(0, 1, 2))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, 0.0)
    return mean, var


def bn_pool_fwd_plain(x: torch.Tensor, sc: torch.Tensor, sh: torch.Tensor,
                      pool) -> torch.Tensor:
    pt, _ = check(x, pool)
    h = [torch.relu(e.float() * sc + sh) for e in windows(x, pt)]
    return pool_windows(h).to(x.dtype)


def _correct(x, dz, mean, inv, ac, s1, s2) -> torch.Tensor:
    """``dx = ac·dz − c1 − n·c2``; N divides as a tensor, as the kernel
    divides (PyTorch on the card multiplies by the reciprocal of a Python
    scalar)."""
    count = s1.new_full((), float(x.shape[0] * x.shape[1] * x.shape[2]))
    c1 = ac * (s1 / count)
    c2 = ac * (s2 / count)
    n = (x.float() - mean) * inv
    return (dz.float() - c1 - n * c2).to(x.dtype)


def bn_pool_bwd_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, pool) -> tuple:
    """``(dx, dγ, dβ)`` of the op at ``x``, given the gradient ``g`` of
    its output and the saved ``mean``, ``inv = rsqrt(var + eps)``."""
    pt, _ = check(x, pool)
    ac = gamma * inv
    ns = [(e.float() - mean) * inv for e in windows(x, pt)]
    h = [torch.relu(n * gamma + beta) for n in ns]
    dzs = route(h, g.float())
    s1 = sum(dz.sum(dim=(0, 1, 2)) for dz in dzs)
    s2 = sum((dz * n).sum(dim=(0, 1, 2)) for dz, n in zip(dzs, ns))
    dz = unwindows([(d * ac).to(x.dtype) for d in dzs], x.shape, pt)
    return _correct(x, dz, mean, inv, ac, s1, s2), s2, s1


_P, _I = _build.P, _build.I


def bn_pool_fwd(x: torch.Tensor, sc: torch.Tensor, sh: torch.Tensor,
                pool) -> torch.Tensor:
    """``x [B, T, M, C]`` → ``[B, T // pt, M // 2, C]`` in x's type, with
    the per-channel f32 affine ``sc``, ``sh`` before the ReLU."""
    pt, tos = check(x, pool)
    if not x.is_cuda:
        return bn_pool_fwd_plain(x, sc, sh, pool)
    check_channels(x)
    x, sc, sh = kernel_ready(x, sc.float(), sh.float())
    b, t, m, c = x.shape
    out = torch.empty(b, tos, m // 2, c, dtype=x.dtype, device=x.device)
    fn = _build.function("bn_pool", "ttg_bn_pool_fwd",
                         [_P] * 4 + [_I] * 6 + [_P])
    err = fn(x.data_ptr(), sc.data_ptr(), sh.data_ptr(), out.data_ptr(), b, t,
             m, c, pt, int(x.dtype == torch.bfloat16), _build.stream())
    launches["bn_pool_fwd"] += 1
    _build.check(err, "ttg_bn_pool_fwd")
    return out


def bn_pool_bwd(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                pool) -> tuple:
    """``(dx [B, T, M, C] in x's type, dγ [C], dβ [C] f32)``."""
    pt, tos = check(x, pool)
    b, t, m, c = x.shape
    if tuple(g.shape) != (b, tos, m // 2, c):
        raise ValueError("g must have the pooled output's shape")
    if not x.is_cuda:
        return bn_pool_bwd_plain(x, g, mean, inv, gamma, beta, pool)
    check_channels(x)
    prm = torch.stack([v.float() for v in (mean, inv, gamma, beta,
                                           gamma * inv)])
    x, g, prm = kernel_ready(x, g.to(x.dtype), prm)
    cv = c * x.element_size() // 16
    if cv > _THREADS:
        raise ValueError(f"the bn_pool kernel takes at most {_THREADS * 16} "
                         "bytes of channels")
    wpb = _ITER * (_THREADS // cv)
    nblk = -(-(b * tos * (m // 2)) // wpb)
    dev = x.device
    dx = torch.empty_like(x)
    part = torch.empty(max(nblk, 1), 2, c, dtype=torch.float32, device=dev)
    s1, s2 = (torch.empty(c, dtype=torch.float32, device=dev)
              for _ in range(2))
    coef = torch.empty(2, c, dtype=torch.float32, device=dev)
    fn = _build.function("bn_pool", "ttg_bn_pool_bwd",
                         [_P] * 8 + [_I] * 7 + [_P])
    err = fn(x.data_ptr(), g.data_ptr(), prm.data_ptr(), dx.data_ptr(),
             part.data_ptr(), s1.data_ptr(), s2.data_ptr(), coef.data_ptr(),
             b, t, m, c, pt, int(x.dtype == torch.bfloat16), wpb,
             _build.stream())
    launches["bn_pool_bwd"] += 1
    _build.check(err, "ttg_bn_pool_bwd")
    return dx, s2, s1


class BnPoolFunction(torch.autograd.Function):
    """``_bn_pool_op``'s custom VJP.  ``mean`` and ``var`` enter as
    constants: the closed-form backward already holds their paths."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, pool, eps):
        inv = torch.rsqrt(var + eps)
        sc = gamma * inv
        sh = beta - mean * sc
        ctx.pool = tuple(pool)
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        return bn_pool_fwd(x, sc, sh, pool)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta = bn_pool_bwd(x, g, mean, inv, gamma, beta,
                                        ctx.pool)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None,
                None, None)


def bn_relu_dual_pool(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, pool, eps: float = 1e-5) -> tuple:
    """``avg_pool(h) + max_pool(h)`` for ``h = relu(BN_train(x))``,
    differentiable in x, γ and β.  Returns ``(out, batch_mean,
    batch_var)``: the caller moves its running statistics with them."""
    with torch.no_grad():
        mean, var = batch_stats(x)
    out = BnPoolFunction.apply(x, gamma, beta, mean, var, tuple(pool), eps)
    return out, mean, var
