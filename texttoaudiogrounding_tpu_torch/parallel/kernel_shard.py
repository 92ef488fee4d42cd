"""The port's counterpart of what GSPMD does around the kernels, made
explicit: a rank's partial sums turned into the ``data`` axis's global sums.

Port of ``texttoaudiogrounding_tpu/parallel/kernel_shard.py``.  Under JAX,
a step on a mesh computes the function of a single-device step on the
whole global batch: XLA reduces every batch statistic over the mesh and
``jax.shard_map`` runs each Pallas kernel on a device's own rows
(``kernel_mesh``, ``wrap_calls``, ``maybe_shard``).  The port needs no
counterpart of those three: each rank is one process that already runs
every kernel on its own rows only.  What it needs instead are the
reductions GSPMD inserts, written out as collectives with their
gradients:

* :func:`data_parallel` makes a mesh's ``data`` axis the active one for
  the model's train-mode forward (a no-op at size 1, so single-rank code
  runs unchanged);
* :func:`global_sums`: a rank's sums over its rows → the sums over the
  global batch, an ``all_reduce`` whose backward is an ``all_reduce`` of
  the gradients (the train-mode BatchNorms' statistics, row 12's);
* :func:`local_rows`: a draw made for the global batch (dropout masks)
  cut to the rank's rows, so that N ranks draw what one rank draws;
* :func:`gather_rows`: the ranks' rows of a tensor in order; its backward
  keeps the rank's own rows of the gradient.  It is right only where every
  rank then computes the same function of the gathered tensor (the loss),
  which makes each rank's gradient that of the global loss over its rows;
* :func:`reduce_from`, :func:`copy_to`, :func:`gather_last`: the
  tensor-parallel layers' collectives over the ``model`` axis
  (``parallel/tensor_parallel.py``).

The gradients of the replicated parameters are then a rank's share of the
global gradient, summed over the ``data`` axis by
``tensor_parallel.sync_grads``.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis as a rank sees it: its process group, its size and
    the rank's coordinate on it."""

    group: object
    size: int
    index: int


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "ttg_torch_data_axis", default=None)


def active_data_axis() -> Axis | None:
    """The ``data`` axis of the forward being run, None outside
    :func:`data_parallel` or at size 1."""
    return _ACTIVE.get()


@contextlib.contextmanager
def data_parallel(mesh):
    """Make ``mesh``'s ``data`` axis (``parallel.mesh.Mesh``) the active
    one; a None mesh or a size-1 axis is a no-op."""
    axis = None if mesh is None else mesh.axis("data")
    token = _ACTIVE.set(axis)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, t.shape[dim]
        return _gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n)
        return own.contiguous(), None, None


def global_sums(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active ``data`` axis (differentiable)."""
    axis = active_data_axis()
    return t if axis is None else _SumOver.apply(t, axis.group)


def global_rows(rows: int) -> int:
    """The global batch's rows, from a rank's ``rows``."""
    axis = active_data_axis()
    return rows if axis is None else rows * axis.size


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """The rank's rows of ``t``, a tensor of the global batch's rows."""
    axis = active_data_axis()
    if axis is None:
        return t
    n = t.shape[0] // axis.size
    return t[axis.index * n:(axis.index + 1) * n]


def global_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialized tensor like ``x`` (its layout in memory too) with
    the global batch's rows: what a rank draws a random mask into before
    :func:`local_rows` cuts it, so that the draws follow one rank's order
    of elements."""
    axis = active_data_axis()
    if axis is None:
        return torch.empty_like(x)
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    shape = (x.shape[0] * axis.size,) + tuple(x.shape[1:])
    buf = x.new_empty([shape[d] for d in order])
    return buf.permute([order.index(d) for d in range(x.dim())])


def gather_rows(t: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The ranks' rows of ``t`` along dim 0, in rank order; the backward
    keeps the rank's own rows (see the module's docstring)."""
    if axis is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _Gather.apply(t, axis, 0)
    return _gather(t, axis, 0)


def gather_last(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ranks' slices of ``t``'s last dim, concatenated; the backward
    keeps the rank's own slice."""
    return _Gather.apply(t, axis, t.dim() - 1)


def reduce_from(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` summed over ``axis``; the gradient passes through (every rank
    of the axis uses the sum alike)."""
    return _ReduceFrom.apply(t, axis.group)


def copy_to(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` as it is; its gradient summed over ``axis`` (each rank of the
    axis uses its own part of it)."""
    return _CopyTo.apply(t, axis.group)


class _GlobalOutput(Mapping):
    def __init__(self, output: dict, rows: tuple, axis: Axis):
        self._src, self._rows, self._axis = output, rows, axis
        self._read: dict = {}

    def __getitem__(self, key):
        if key not in self._read:
            v = self._src[key]
            if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] in self._rows:
                v = gather_rows(v, self._axis)
            self._read[key] = v
        return self._read[key]

    def __iter__(self):
        return iter(self._src)

    def __len__(self) -> int:
        return len(self._src)


def global_output(output: dict, rows, axis: Axis | None) -> Mapping:
    """A rank's model output over ``rows`` rows (an int, or a tuple of the
    row counts its tensors have: a mixup step's outputs have half the
    batch's) as the global batch's: each tensor whose leading dim is one
    of ``rows`` is gathered over ``axis`` (:func:`gather_rows`) when first
    read, so a loss gathers only what it reads (every rank reads the same
    entries in the same order)."""
    if axis is None:
        return output
    return _GlobalOutput(output, (rows,) if isinstance(rows, int)
                         else tuple(rows), axis)
