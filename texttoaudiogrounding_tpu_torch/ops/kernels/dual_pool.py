"""ReLU → avg + max pool with a mask-recompute backward: ``csrc/dual_pool.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/dual_pool.py:263
dual_pool_relu``: ``out = avg_pool(relu(x)) + max_pool(relu(x))`` with
window = stride = ``(pt, 2)``, ``pt`` in {1, 2}, floor pooling over T, on
channel-last ``x [B, T, M, C]`` (f32 or bf16); the sums run in f32 and the
output is rounded once to x's type.  The backward recomputes the windows
from the saved x: the max share goes to the first maximal element in
window order (dt, dm), as torch routes it; ReLU's gradient at 0 is 0; the
rows that floor pooling drops get zero gradient.

Each wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version of the same arithmetic for CPU tensors; ``launches``
counts the kernel launches by wrapper.  :class:`DualPoolFunction` joins the
two as the JAX custom VJP does.
"""

from __future__ import annotations

import functools

import torch

from texttoaudiogrounding_tpu_torch.ops.kernels import _build

launches = {"dual_pool_fwd": 0, "dual_pool_bwd": 0}

POOLS = ((2, 2), (1, 2))


def check(x: torch.Tensor, pool) -> tuple:
    """(pt, T // pt) for a supported input, else raises."""
    pool = tuple(pool)
    if pool not in POOLS:
        raise ValueError(f"pool must be one of {POOLS}")
    if x.dim() != 4 or x.shape[2] % 2:
        raise ValueError("x must be [B, T, M, C] with M even")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("x must be float32 or bfloat16")
    pt = pool[0]
    return pt, x.shape[1] // pt


def windows(x: torch.Tensor, pt: int) -> list:
    """The 2 pt window elements of x's complete windows, in window order
    (dt, dm), each ``[B, T // pt, M // 2, C]``."""
    b, t, m, c = x.shape
    t2 = t // pt * pt
    v = x[:, :t2].reshape(b, t2 // pt, pt, m // 2, 2, c)
    return [v[:, :, dt, :, dm] for dt in range(pt) for dm in range(2)]


def unwindows(parts: list, shape, pt: int) -> torch.Tensor:
    """Inverse of :func:`windows`: the window elements back in ``shape``
    ``[B, T, M, C]``, zero in the rows floor pooling drops."""
    b, t, m, c = shape
    t2 = t // pt * pt
    v = torch.stack(parts).reshape(pt, 2, b, t2 // pt, m // 2, c)
    v = v.permute(2, 3, 0, 4, 1, 5).reshape(b, t2, m, c)
    if t2 == t:
        return v
    return torch.cat([v, v.new_zeros(b, t - t2, m, c)], dim=1)


def pool_windows(h: list) -> torch.Tensor:
    """avg + max of the window elements in f32, summed as the kernel sums
    them: ``((e0 + e1) + (e2 + e3)) / K + max``."""
    s = h[0] + h[1] if len(h) == 2 else (h[0] + h[1]) + (h[2] + h[3])
    return s * (1.0 / len(h)) + functools.reduce(torch.maximum, h)


def route(h: list, g: torch.Tensor) -> list:
    """Gradient of avg + max at each window element (h = the ReLU
    outputs, f32): ``g / K``, plus ``g`` at the first maximal element in
    window order, 0 where h is 0 (``dual_pool.py:69-83``)."""
    mx = functools.reduce(torch.maximum, h)
    gavg = g * (1.0 / len(h))
    taken = torch.zeros_like(mx, dtype=torch.bool)
    out = []
    for e in h:
        hit = (e == mx) & ~taken
        taken = taken | hit
        d = torch.where(hit, gavg + g, gavg)
        out.append(torch.where(e > 0, d, torch.zeros_like(d)))
    return out


def dual_pool_fwd_plain(x: torch.Tensor, pool) -> torch.Tensor:
    pt, _ = check(x, pool)
    h = [torch.relu(e.float()) for e in windows(x, pt)]
    return pool_windows(h).to(x.dtype)


def dual_pool_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                        pool) -> torch.Tensor:
    pt, _ = check(x, pool)
    h = [torch.relu(e.float()) for e in windows(x, pt)]
    ds = route(h, g.float())
    return unwindows([d.to(x.dtype) for d in ds], x.shape, pt)


def kernel_ready(*tensors: torch.Tensor) -> list:
    """Contiguous, 16-byte aligned tensors on one CUDA device."""
    dev = tensors[0].device
    out = []
    for t in tensors:
        if t.device != dev:
            raise ValueError("the pool kernels' inputs must lie on one device")
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def check_channels(x: torch.Tensor) -> None:
    words = x.shape[3] * x.element_size()
    if words % 16:
        raise ValueError("the pool kernels need C a multiple of 16 bytes")


_P, _I = _build.P, _build.I


def dual_pool_fwd(x: torch.Tensor, pool) -> torch.Tensor:
    """``x [B, T, M, C]`` → ``[B, T // pt, M // 2, C]`` in x's type."""
    pt, tos = check(x, pool)
    if not x.is_cuda:
        return dual_pool_fwd_plain(x, pool)
    check_channels(x)
    (x,) = kernel_ready(x)
    b, t, m, c = x.shape
    out = torch.empty(b, tos, m // 2, c, dtype=x.dtype, device=x.device)
    if b == 0:                       # a rank with no rows
        return out
    fn = _build.function("dual_pool", "ttg_dual_pool_fwd",
                         [_P, _P] + [_I] * 6 + [_P])
    err = fn(x.data_ptr(), out.data_ptr(), b, t, m, c, pt,
             int(x.dtype == torch.bfloat16), _build.stream(x))
    launches["dual_pool_fwd"] += 1
    _build.check(err, "ttg_dual_pool_fwd")
    return out


def dual_pool_bwd(x: torch.Tensor, g: torch.Tensor, pool) -> torch.Tensor:
    """The gradient ``dx [B, T, M, C]`` (x's type) of :func:`dual_pool_fwd`
    at ``x``, given the gradient ``g`` of its output."""
    pt, tos = check(x, pool)
    b, t, m, c = x.shape
    if tuple(g.shape) != (b, tos, m // 2, c):
        raise ValueError("g must have the pooled output's shape")
    if not x.is_cuda:
        return dual_pool_bwd_plain(x, g, pool)
    check_channels(x)
    x, g = kernel_ready(x, g.to(x.dtype))
    dx = torch.empty_like(x)
    if b == 0:                       # a rank with no rows
        return dx
    fn = _build.function("dual_pool", "ttg_dual_pool_bwd",
                         [_P] * 3 + [_I] * 6 + [_P])
    err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), b, t, m, c, pt,
             int(x.dtype == torch.bfloat16), _build.stream(x))
    launches["dual_pool_bwd"] += 1
    _build.check(err, "ttg_dual_pool_bwd")
    return dx


class DualPoolFunction(torch.autograd.Function):
    """``dual_pool_relu``'s custom VJP: the forward saves x, the backward
    recomputes the windows from it."""

    @staticmethod
    def forward(ctx, x, pool):
        ctx.pool = tuple(pool)
        ctx.save_for_backward(x)
        return dual_pool_fwd(x, pool)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return dual_pool_bwd(x, g, ctx.pool), None


def dual_pool_relu(x: torch.Tensor, pool) -> torch.Tensor:
    """``avg_pool(relu(x)) + max_pool(relu(x))``, differentiable in x."""
    return DualPoolFunction.apply(x, tuple(pool))
