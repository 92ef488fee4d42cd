"""Train-mode BatchNorm → ReLU → avg + max pool: ``csrc/bn_pool.cu`` and
``csrc/bn_pool_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/bn_pool.py:376
bn_relu_dual_pool``.  The batch statistics of ``x [B, T, M, C]`` (f32 or
bf16, channel-last) are f32 ``E[x²] − E[x]²``, clipped at 0, over (B, T,
M), flax's fast variance (the JAX wrapper takes them with XLA reductions);
on the card one pass of ``bn_pool_stats`` reads x once.

* Forward, one kernel pass: ``h = relu(x·sc + sh)`` in f32 (``sc = γ
  rsqrt(var + eps)``, ``sh = β − mean·sc``), then the dual pool of
  ``dual_pool.py`` (window = stride = ``(pt, 2)``, floor pooling), rounded
  once to x's type.
* Backward: recompute ``n = (x − mean)·inv`` and ``h = relu(n γ + β)``,
  route the window gradients (first maximal element in window order, zero
  at relu(0)), sum ``s1 = Σdz``, ``s2 = Σdz·n``; then the closed-form
  train-BN correction ``dx = round_x(ac·dz) − ac·s1/N − n·ac·s2/N`` with
  ``ac = γ·inv``, ``N = B·T·M`` over the full T, ``dγ = s2``, ``dβ = s1``
  (``bn_pool.py:343-368``; ``ac·dz`` is rounded to x's type where the JAX
  kernel stores it).  On the card the default design (``"two_pass"``) is
  two launches of ``bn_pool_v2.cu`` over one persistent grid: the sums,
  summed over CTAs in a fixed order by the last CTA, then dx, with ``ac·dz``
  never in device memory.  The first design (``"three_pass"``, ``bn_pool.cu``:
  ``ac·dz`` written and read again, a reduction launch between) stays
  callable and counts apart.
* Under a data axis (``parallel/kernel_shard.py``) the statistics and the
  backward's sums are the global batch's, as the JAX package reduces them
  in XLA around the per-shard kernel (``bn_pool.py:303-313``, ``:395-398``):
  :func:`global_batch_stats` sums each rank's ``(Σx, Σx²)`` (one
  ``bn_pool_stats`` launch through ``ttg_bn_pool_sums``) over the ranks,
  and :func:`bn_pool_bwd_global` runs the second design split at its sums
  (``ttg_bn_pool_bwd_v2_sums``, the ranks' s1 / s2 summed,
  ``ttg_bn_pool_bwd_v2_apply``; counters ``bn_pool_bwd_sums`` /
  ``bn_pool_bwd_apply``).  The first design sums and applies in one call
  and is not split: it raises under a data axis.

Each wrapper launches the kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors; ``launches`` counts the kernel launches.
The ``*_emulated`` functions repeat the second design's orders of summation
on the CPU.  The persistent kernels' scratch (partial sums and a done
counter) is allocated once a device, stream and channel count and reused
in that stream's order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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
from texttoaudiogrounding_tpu_torch.parallel import kernel_shard

launches = {"bn_pool_fwd": 0, "bn_pool_bwd": 0, "bn_pool_bwd_three_pass": 0,
            "bn_pool_stats": 0, "bn_pool_bwd_sums": 0, "bn_pool_bwd_apply": 0}

DESIGNS = ("two_pass", "three_pass")
THREADS = 512      # threads of a bn_pool_v2.cu CTA (csrc/bn_pool_v2.cu)
_THREADS = 256     # threads of the route pass's blocks (csrc/bn_pool.cu)
_ITER = 16         # windows each thread row takes in the route pass
_AHEAD = 8         # rows a bn_pool_stats thread sums in a tree at once


def batch_stats_plain(x: torch.Tensor) -> tuple:
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


def _rows(x: torch.Tensor) -> int:
    return x.shape[0] * x.shape[1] * x.shape[2]


def _global_rows(x: torch.Tensor, axis) -> int:
    """The (B, T, M) rows of the global batch whose rank's rows are
    ``x``."""
    return axis.total(x.shape[0]) * x.shape[1] * x.shape[2]


def _coef(gamma, inv, s1, s2, count: int) -> torch.Tensor:
    """``[c1, c2] = ac·s1 / N, ac·s2 / N`` (``ac = γ·inv``); N divides as a
    tensor, as the kernel divides (PyTorch on the card multiplies by the
    reciprocal of a Python scalar)."""
    n = s1.new_full((), float(count))
    ac = gamma * inv
    return torch.stack([ac * (s1 / n), ac * (s2 / n)])


def _correct(x, dz, mean, inv, coef) -> torch.Tensor:
    """``dx = ac·dz − c1 − n·c2``."""
    n = (x.float() - mean) * inv
    return (dz.float() - coef[0] - n * coef[1]).to(x.dtype)


def _routed(x, g, mean, inv, gamma, beta, pt: int) -> tuple:
    """``n = (x − mean)·inv`` and the routed ``dz`` of each window
    element."""
    ns = [(e.float() - mean) * inv for e in windows(x, pt)]
    h = [torch.relu(n * gamma + beta) for n in ns]
    return ns, route(h, g.float())


def _sums(ns: list, dzs: list) -> tuple:
    return (sum(dz.sum(dim=(0, 1, 2)) for dz in dzs),
            sum((dz * n).sum(dim=(0, 1, 2)) for dz, n in zip(dzs, ns)))


def _apply(x, dzs, mean, inv, gamma, pt: int, coef) -> torch.Tensor:
    ac = gamma * inv
    dz = unwindows([(d * ac).to(x.dtype) for d in dzs], x.shape, pt)
    return _correct(x, dz, mean, inv, coef)


def bn_pool_bwd_sums_plain(x, g, mean, inv, gamma, beta, pool) -> tuple:
    """``(s1, s2) = (Σdz, Σdz·n)`` over x's rows (f32 [C])."""
    pt, _ = check(x, pool)
    return _sums(*_routed(x, g, mean, inv, gamma, beta, pt))


def bn_pool_bwd_apply_plain(x, g, mean, inv, gamma, beta, pool, s1, s2,
                            count: int) -> torch.Tensor:
    """dx given the sums ``s1``, ``s2`` over ``count`` rows (the global
    batch's under a data axis)."""
    pt, _ = check(x, pool)
    _, dzs = _routed(x, g, mean, inv, gamma, beta, pt)
    return _apply(x, dzs, mean, inv, gamma, pt,
                  _coef(gamma, inv, s1, s2, count))


def bn_pool_bwd_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, pool) -> tuple:
    """``(dx, dγ, dβ)`` of the op at ``x``, given the gradient ``g`` of
    its output and the saved ``mean``, ``inv = rsqrt(var + eps)``."""
    pt, _ = check(x, pool)
    ns, dzs = _routed(x, g, mean, inv, gamma, beta, pt)
    s1, s2 = _sums(ns, dzs)
    return (_apply(x, dzs, mean, inv, gamma, pt,
                   _coef(gamma, inv, s1, s2, _rows(x))), s2, s1)


def _tree(t: torch.Tensor) -> torch.Tensor:
    """Rows of ``t`` summed in the kernels' tree (``tree_rows``): with p the
    largest power of two below n, row r += row r + p (r + p < n), then p
    halves."""
    t = t.clone()
    n = t.shape[0]
    p = 1
    while 2 * p < n:
        p *= 2
    while p > 0:
        k = min(p, n - p)
        if k > 0:
            t[:k] = t[:k] + t[p:p + k]
        p //= 2
    return t[0]


def _cta_layout(items: torch.Tensor, grid: int, per_cta: int,
                rows: int, mult: int = 1) -> torch.Tensor:
    """``items [n, C]`` as ``[grid, J, rows, C]``: CTA k takes items k·per_cta
    … in order, item j·rows + ty of a CTA going to thread row ty; zeros
    past the end (J a multiple of ``mult``)."""
    n, c = items.shape
    if grid * per_cta < n:
        raise ValueError("grid · rows_per_cta must cover every row")
    j = -(-per_cta // rows)
    j = -(-j // mult) * mult
    out = items.new_zeros(grid * per_cta, c)
    out[:n] = items
    out = out.view(grid, per_cta, c)
    out = torch.cat([out, out.new_zeros(grid, j * rows - per_cta, c)], 1)
    return out.view(grid, j, rows, c)


def _sum_parts(part: torch.Tensor, nt: int) -> torch.Tensor:
    """``part [G, w]`` summed as the last CTA sums it (``sum_parts``): lane
    r of L = nt // (w / 4) adds rows r, r + L, … in turn, then the lanes'
    tree."""
    g, w = part.shape
    lanes = nt // (w // 4) if w // 4 <= nt else 1
    acc = part.new_zeros(lanes, w)
    for k in range(g):
        acc[k % lanes] = acc[k % lanes] + part[k]
    return _tree(acc)


def _thread_rows(x: torch.Tensor, threads: int) -> tuple:
    """(thread rows R, threads nt) of a ``bn_pool_v2.cu`` CTA for x's C."""
    cv = x.shape[-1] * x.element_size() // 16
    if cv < 1 or cv > threads:
        raise ValueError(f"C must be 1 to {threads} 16-byte words")
    rows = threads // cv
    return rows, rows * cv


def batch_stats_emulated(x: torch.Tensor, grid: int, rows_per_cta: int,
                         threads: int = THREADS) -> tuple:
    """``bn_pool_stats``'s ``(mean, var)`` on the CPU in its orders of
    summation: each thread its rows eight at a time, each eight in a tree;
    the CTA's thread rows in a tree; the CTAs as the last one sums them."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    r, nt = _thread_rows(x, threads)
    lay = _cta_layout(xf, grid, rows_per_cta, r, _AHEAD)
    s = xf.new_zeros(grid, r, c)
    q = xf.new_zeros(grid, r, c)
    for j in range(0, lay.shape[1], _AHEAD):
        e = lay[:, j:j + _AHEAD].transpose(0, 1)
        s = s + _tree(e)
        q = q + _tree(e * e)
    part = torch.stack([torch.cat([_tree(s[k]), _tree(q[k])])
                        for k in range(grid)])
    tot = _sum_parts(part, nt)
    count = tot.new_full((), float(xf.shape[0]))
    mean = tot[:c] / count
    return mean, torch.clamp_min(tot[c:] / count - mean * mean, 0.0)


def bn_pool_bwd_emulated(x: torch.Tensor, g: torch.Tensor,
                         mean: torch.Tensor, inv: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor, pool,
                         grid: int, rows_per_cta: int,
                         threads: int = THREADS,
                         rounding: bool = True) -> tuple:
    """The second design's ``(dx, dγ, dβ)`` on the CPU in its orders of
    summation: each thread the dz and dz·n of its windows w0 + ty + j·R in
    turn (window elements in window order), the CTA's thread rows in a tree,
    the CTAs as the last one sums them.  ``rounding=False`` keeps ``ac·dz``
    in f32 where the kernel rounds it to x's type."""
    pt, _ = check(x, pool)
    b, t, m, c = x.shape
    r, nt = _thread_rows(x, threads)
    ns = [(e.float() - mean) * inv for e in windows(x, pt)]
    h = [torch.relu(n * gamma + beta) for n in ns]
    dzs = route(h, g.float())
    per = rows_per_cta * (m // 2)
    dl = [_cta_layout(d.reshape(-1, c), grid, per, r) for d in dzs]
    nl = [_cta_layout(n.reshape(-1, c), grid, per, r) for n in ns]
    s1 = x.new_zeros(grid, r, c, dtype=torch.float32)
    s2 = torch.zeros_like(s1)
    for j in range(dl[0].shape[1]):
        for d, n in zip(dl, nl):
            s1 = s1 + d[:, j]
            s2 = s2 + d[:, j] * n[:, j]
    part = torch.stack([torch.cat([_tree(s1[k]), _tree(s2[k])])
                        for k in range(grid)])
    tot = _sum_parts(part, nt)
    s1, s2 = tot[:c], tot[c:]
    ac = gamma * inv
    parts = [d * ac for d in dzs]
    if rounding:
        parts = [d.to(x.dtype) for d in parts]
    dz = unwindows(parts, x.shape, pt)
    return (_correct(x, dz, mean, inv, _coef(gamma, inv, s1, s2, _rows(x))),
            s2, s1)


_P, _I, _L = _build.P, _build.I, _build.L
_scratch: dict = {}


def _buffers(device: torch.device, c: int) -> tuple:
    """(grid, part [grid, 2, C] f32, a zeroed done counter) of a
    ``bn_pool_v2.cu`` launch on the current stream: one CTA an SM
    (``__launch_bounds__(THREADS, 1)``; a second would double the last CTA's
    serial sum).  Made once a device, stream and C and reused in stream
    order; each launch leaves the counter at 0."""
    grid = torch.cuda.get_device_properties(device).multi_processor_count
    key = (device, torch.cuda.current_stream(device).cuda_stream, c)
    if key not in _scratch:
        _scratch[key] = (
            torch.empty(grid, 2, c, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))
    return (grid,) + _scratch[key]


def batch_stats(x: torch.Tensor) -> tuple:
    """f32 ``(mean, var)`` of ``x [B, T, M, C]`` over (B, T, M), flax's fast
    variance; one ``bn_pool_stats`` launch for CUDA tensors."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("x must be [B, T, M, C], float32 or bfloat16")
    if not x.is_cuda:
        return batch_stats_plain(x)
    return _stats_launch(x, "ttg_bn_pool_stats")


def _stats_launch(x: torch.Tensor, entry: str) -> tuple:
    """One ``bn_pool_stats`` launch through ``entry``: ``(mean, var)``
    (``ttg_bn_pool_stats``) or ``(Σx, Σx²)`` (``ttg_bn_pool_sums``)."""
    check_channels(x)
    (x,) = kernel_ready(x)
    c = x.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if c * x.element_size() // 16 > THREADS:
        raise ValueError(f"bn_pool_stats takes at most {THREADS * 16} bytes "
                         "of channels")
    rows = x.numel() // c
    grid, part, done = _buffers(x.device, c)
    rpc = max(1, -(-rows // grid))
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    fn = _build.function("bn_pool_v2", entry,
                         [_P] * 5 + [_L, _I, _I, _I, _L, _P])
    err = fn(x.data_ptr(), part.data_ptr(), done.data_ptr(), out[0].data_ptr(),
             out[1].data_ptr(), rows, c, int(bf16), grid, rpc,
             _build.stream(x))
    launches["bn_pool_stats"] += 1
    _build.check(err, entry)
    return out[0], out[1]


def _no_sums(x: torch.Tensor) -> tuple:
    """The two per-channel f32 sums of a rank with no rows (a mixup whose
    pairs span the ranks, ``kernel_shard.mixup_rows``): zeros, with
    nothing to launch."""
    zero = torch.zeros(x.shape[3], dtype=torch.float32, device=x.device)
    return zero, zero.clone()


def batch_sums_plain(x: torch.Tensor) -> tuple:
    """f32 ``(Σx, Σx²)`` over (B, T, M)."""
    xf = x.float()
    return xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2))


def batch_sums(x: torch.Tensor) -> tuple:
    """f32 ``(Σx, Σx²)`` of ``x [B, T, M, C]`` over (B, T, M), a rank's
    share of a data axis's statistics; one ``bn_pool_stats`` launch (its
    sums, in its order of summation) for CUDA tensors."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("x must be [B, T, M, C], float32 or bfloat16")
    if not x.is_cuda:
        return batch_sums_plain(x)
    if x.shape[0] == 0:              # a rank with no rows
        return _no_sums(x)
    return _stats_launch(x, "ttg_bn_pool_sums")


def global_batch_stats(x: torch.Tensor, axis) -> tuple:
    """f32 ``(mean, var)`` of the global batch whose rows ``x`` shares with
    the other ranks of ``axis`` (a ``kernel_shard.Axis``): the ranks' sums
    summed, then flax's fast variance over the global batch's rows (its
    row layout: ``axis.total``)."""
    tot = torch.stack(batch_sums(x))
    dist.all_reduce(tot, group=axis.group)
    count = tot.new_full((), float(_global_rows(x, axis)))
    mean = tot[0] / count
    return mean, torch.clamp_min(tot[1] / count - mean * mean, 0.0)


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
    if b == 0:                       # a rank with no rows
        return out
    fn = _build.function("bn_pool", "ttg_bn_pool_fwd",
                         [_P] * 4 + [_I] * 6 + [_P])
    err = fn(x.data_ptr(), sc.data_ptr(), sh.data_ptr(), out.data_ptr(), b, t,
             m, c, pt, int(x.dtype == torch.bfloat16), _build.stream(x))
    launches["bn_pool_fwd"] += 1
    _build.check(err, "ttg_bn_pool_fwd")
    return out


def _bwd_args(x, g, mean, inv, gamma, beta, pool) -> tuple:
    """The checked kernel operands of a backward call and its geometry."""
    pt, tos = check(x, pool)
    b, t, m, c = x.shape
    if tuple(g.shape) != (b, tos, m // 2, c):
        raise ValueError("g must have the pooled output's shape")
    return pt, tos


def _v2_launch(x, g, mean, inv, gamma, beta, pt: int, tos: int,
               entry: str, given=None) -> tuple:
    """One call of a ``bn_pool_v2.cu`` backward entry: ``"ttg_bn_pool_bwd_v2"``
    (both passes: dx, s1, s2), ``"..._sums"`` (pass 1: s1, s2) or
    ``"..._apply"`` (pass 2 with ``given = (s1, s2, count)``: dx)."""
    check_channels(x)
    x, g, mean, inv, gamma, beta = kernel_ready(
        x, g.to(x.dtype), *(v.float() for v in (mean, inv, gamma, beta)))
    b, t, m, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    if c * x.element_size() // 16 > THREADS:
        raise ValueError(f"the bn_pool_v2 kernels take at most {THREADS * 16} "
                         "bytes of channels")
    grid, part, done = _buffers(x.device, c)
    rpc = max(1, -(-(b * tos) // grid))
    geometry = (b, t, m, c, pt, int(bf16), grid, rpc, _build.stream(x))
    operands = [v.data_ptr() for v in (x, g, mean, inv, gamma, beta)]
    if entry.endswith("_apply"):
        s1, s2, count = given
        s1, s2 = kernel_ready(s1.float(), s2.float())
        dx = torch.empty_like(x)
        fn = _build.function("bn_pool_v2", entry,
                             [_P] * 8 + [_L, _P] + [_I] * 8 + [_P])
        err = fn(*operands, s1.data_ptr(), s2.data_ptr(), count,
                 dx.data_ptr(), *geometry)
        launches["bn_pool_bwd_apply"] += 1
        _build.check(err, entry)
        return (dx,)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    tail = [part.data_ptr(), done.data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr()]
    if entry.endswith("_sums"):
        fn = _build.function("bn_pool_v2", entry, [_P] * 10 + [_I] * 8 + [_P])
        err = fn(*operands, *tail, *geometry)
        launches["bn_pool_bwd_sums"] += 1
        _build.check(err, entry)
        return sums[0], sums[1]
    dx = torch.empty_like(x)
    fn = _build.function("bn_pool_v2", entry, [_P] * 11 + [_I] * 8 + [_P])
    err = fn(*operands, dx.data_ptr(), *tail, *geometry)
    launches["bn_pool_bwd"] += 1
    _build.check(err, entry)
    return dx, sums[0], sums[1]


def bn_pool_bwd(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                pool, design: str = "two_pass") -> tuple:
    """``(dx [B, T, M, C] in x's type, dγ [C], dβ [C] f32)``; ``design``
    picks the card's kernels (``"two_pass"``, or the first design
    ``"three_pass"``)."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}")
    if design == "three_pass" and kernel_shard.active_data_axis():
        raise ValueError("three_pass applies its sums in the call that makes "
                         "them; under a data axis use bn_pool_bwd_global")
    pt, tos = _bwd_args(x, g, mean, inv, gamma, beta, pool)
    if not x.is_cuda:
        return bn_pool_bwd_plain(x, g, mean, inv, gamma, beta, pool)
    check_channels(x)
    if design == "three_pass":
        return _bwd_three_pass(x, g, mean, inv, gamma, beta, pt, tos)
    dx, s1, s2 = _v2_launch(x, g, mean, inv, gamma, beta, pt, tos,
                            "ttg_bn_pool_bwd_v2")
    return dx, s2, s1


def bn_pool_bwd_sums(x, g, mean, inv, gamma, beta, pool) -> tuple:
    """``(s1, s2)`` of x's rows: the second design's pass 1 alone on the
    card (``ttg_bn_pool_bwd_v2_sums``), the plain version on the CPU."""
    pt, tos = _bwd_args(x, g, mean, inv, gamma, beta, pool)
    if not x.is_cuda:
        return bn_pool_bwd_sums_plain(x, g, mean, inv, gamma, beta, pool)
    if x.shape[0] == 0:              # a rank with no rows
        return _no_sums(x)
    return _v2_launch(x, g, mean, inv, gamma, beta, pt, tos,
                      "ttg_bn_pool_bwd_v2_sums")


def bn_pool_bwd_apply(x, g, mean, inv, gamma, beta, pool, s1, s2,
                      count: int) -> torch.Tensor:
    """dx from the sums ``s1``, ``s2`` over ``count`` rows: pass 2 alone on
    the card (``ttg_bn_pool_bwd_v2_apply``), the plain version on the
    CPU."""
    pt, tos = _bwd_args(x, g, mean, inv, gamma, beta, pool)
    if not x.is_cuda:
        return bn_pool_bwd_apply_plain(x, g, mean, inv, gamma, beta, pool,
                                       s1, s2, count)
    if x.shape[0] == 0:              # a rank with no rows
        return torch.empty_like(x)
    return _v2_launch(x, g, mean, inv, gamma, beta, pt, tos,
                      "ttg_bn_pool_bwd_v2_apply", (s1, s2, count))[0]


def bn_pool_bwd_global(x, g, mean, inv, gamma, beta, pool, axis) -> tuple:
    """The backward of a rank's rows under a data axis (a
    ``kernel_shard.Axis``): ``(dx, dγ, dβ)`` with dx corrected by the
    global batch's sums (the ranks' s1 / s2 summed between the two
    passes, as the JAX package sums the kernel's per-shard partials in
    XLA, ``bn_pool.py:303-313``); dγ and dβ are the rank's shares."""
    s1, s2 = bn_pool_bwd_sums(x, g, mean, inv, gamma, beta, pool)
    tot = torch.stack([s1, s2])
    dist.all_reduce(tot, group=axis.group)
    dx = bn_pool_bwd_apply(x, g, mean, inv, gamma, beta, pool, tot[0],
                           tot[1], _global_rows(x, axis))
    return dx, s2, s1


def _bwd_three_pass(x, g, mean, inv, gamma, beta, pt: int, tos: int) -> tuple:
    """The first design: ``csrc/bn_pool.cu``'s route, reduce and apply."""
    b, t, m, c = x.shape
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
             _build.stream(x))
    launches["bn_pool_bwd_three_pass"] += 1
    _build.check(err, "ttg_bn_pool_bwd")
    return dx, s2, s1


class BnPoolFunction(torch.autograd.Function):
    """``_bn_pool_op``'s custom VJP.  ``mean`` and ``var`` enter as
    constants: the closed-form backward already holds their paths.  Under
    a data axis ``axis`` the backward is :func:`bn_pool_bwd_global`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, pool, eps, axis=None):
        inv = torch.rsqrt(var + eps)
        sc = gamma * inv
        sh = beta - mean * sc
        ctx.pool, ctx.axis = tuple(pool), axis
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        return bn_pool_fwd(x, sc, sh, pool)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        if ctx.axis is None:
            dx, dgamma, dbeta = bn_pool_bwd(x, g, mean, inv, gamma, beta,
                                            ctx.pool)
        else:
            dx, dgamma, dbeta = bn_pool_bwd_global(x, g, mean, inv, gamma,
                                                   beta, ctx.pool, ctx.axis)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None,
                None, None, None)


def bn_relu_dual_pool(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, pool, eps: float = 1e-5) -> tuple:
    """``avg_pool(h) + max_pool(h)`` for ``h = relu(BN_train(x))``,
    differentiable in x, γ and β.  Returns ``(out, batch_mean,
    batch_var)``: the caller moves its running statistics with them.
    Under an active data axis (``parallel/kernel_shard.py``) the
    statistics and the backward's sums are the global batch's."""
    axis = kernel_shard.active_data_axis()
    with torch.no_grad():
        mean, var = (batch_stats(x) if axis is None
                     else global_batch_stats(x, axis))
    out = BnPoolFunction.apply(x, gamma, beta, mean, var, tuple(pool), eps,
                               axis)
    return out, mean, var
