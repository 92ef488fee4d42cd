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
* :func:`mixup_pairs`: rows 2k and 2k + 1 of the global batch mixed where
  a pair spans two ranks (a rank's row count is odd): the ranks' rows
  gathered, each rank mixing the pairs whose even row it holds
  (:func:`mixup_rows`), so that the ranks then hold unequal row counts,
  one of them possibly none.  :func:`set_rows` makes that layout the
  active axis's for the rest of the forward, and every helper above reads
  it: the global row count, a rank's offset, and a gather of unequal
  parts;
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
import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis as a rank sees it: its process group, its size and
    the rank's coordinate on it.  ``rows``, where set, is each rank's row
    count of the tensors being computed (after a mixup whose pairs span
    the ranks, :func:`mixup_rows`); None is the even split, where every
    rank holds as many rows as this one."""

    group: object
    size: int
    index: int
    rows: tuple | None = None

    def counts(self, rows: int) -> tuple:
        """Each rank's row count, this rank holding ``rows``."""
        if self.rows is None:
            return (rows,) * self.size
        if self.rows[self.index] != rows:
            raise ValueError(f"a rank of the layout {self.rows} holds "
                             f"{self.rows[self.index]} rows, not {rows}")
        return self.rows

    def total(self, rows: int) -> int:
        """The global batch's rows, this rank holding ``rows``."""
        return sum(self.counts(rows))

    def offset(self, rows: int) -> int:
        """The global index of this rank's first row."""
        return sum(self.counts(rows)[:self.index])


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "ttg_torch_data_axis", default=None)


def active_data_axis() -> Axis | None:
    """The ``data`` axis of the forward being run, None outside
    :func:`data_parallel` or at size 1."""
    return _ACTIVE.get()


@contextlib.contextmanager
def using_axis(axis: Axis | None):
    """Make ``axis`` the active ``data`` axis inside the block (None: no
    axis); the axis active before, as it was, comes back after it, also
    where :func:`set_rows` changed the layout inside."""
    token = _ACTIVE.set(axis)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def data_parallel(mesh):
    """Make ``mesh``'s ``data`` axis (``parallel.mesh.Mesh``) the active
    one (:func:`using_axis`); a None mesh or a size-1 axis is a no-op."""
    return using_axis(None if mesh is None else mesh.axis("data"))


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


def _gather(t: torch.Tensor, axis: Axis, dim: int,
            counts: tuple | None = None) -> torch.Tensor:
    """The ranks' parts of ``t`` along ``dim``; ``counts`` (each rank's
    length there) where they differ: each part padded to the longest,
    gathered and cut back."""
    if counts is None or len(set(counts)) == 1:
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(parts, t.contiguous(), group=axis.group)
        return torch.cat(parts, dim=dim)
    most = max(counts)
    pad = list(t.shape)
    pad[dim] = most - t.shape[dim]
    full = torch.cat([t, t.new_zeros(pad)], dim=dim).contiguous()
    parts = [torch.empty_like(full) for _ in range(axis.size)]
    dist.all_gather(parts, full, group=axis.group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, counts)],
                     dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim, counts=None):
        n = t.shape[dim]
        ctx.dim, ctx.n = dim, n
        ctx.start = (sum(counts[:axis.index]) if counts is not None
                     else axis.index * n)
        return _gather(t, axis, dim, counts)

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, ctx.start, ctx.n)
        return own.contiguous(), None, None, None


class _GatherShared(torch.autograd.Function):
    """The ranks' rows, each rank computing its own function of them: the
    backward sums the ranks' gradients before keeping the rank's rows."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis, ctx.n = axis, t.shape[0]
        return _gather(t, axis, 0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g.narrow(0, ctx.axis.index * ctx.n, ctx.n).contiguous(), None


def global_sums(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active ``data`` axis (differentiable)."""
    axis = active_data_axis()
    return t if axis is None else _SumOver.apply(t, axis.group)


def global_rows(rows: int) -> int:
    """The global batch's rows, from a rank's ``rows``."""
    axis = active_data_axis()
    return rows if axis is None else axis.total(rows)


def local_rows(t: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """The rank's rows of ``t``, a tensor of the global batch's rows;
    ``rows`` is the rank's count (the even split's where None)."""
    axis = active_data_axis()
    if axis is None:
        return t
    if rows is None:
        rows = (t.shape[0] // axis.size if axis.rows is None
                else axis.rows[axis.index])
    start = axis.offset(rows)
    return t[start:start + rows]


def global_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialized tensor like ``x`` (its layout in memory too) with
    the global batch's rows: what a rank draws a random mask into before
    :func:`local_rows` cuts it, so that the draws follow one rank's order
    of elements."""
    axis = active_data_axis()
    if axis is None:
        return torch.empty_like(x)
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    shape = (axis.total(x.shape[0]),) + tuple(x.shape[1:])
    buf = x.new_empty([shape[d] for d in order])
    return buf.permute([order.index(d) for d in range(x.dim())])


def gather_rows(t: torch.Tensor, axis: Axis | None,
                counts: tuple | None = None) -> torch.Tensor:
    """The ranks' rows of ``t`` along dim 0, in rank order; the backward
    keeps the rank's own rows (see the module's docstring).  ``counts``:
    each rank's rows where they differ (None: as many as this rank's)."""
    if axis is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _Gather.apply(t, axis, 0, counts)
    return _gather(t, axis, 0, counts)


def mixup_rows(rows: int, axis: Axis | None) -> tuple:
    """Each rank's count of mixed rows when every rank holds ``rows`` rows
    of the batch: mixed row k (of rows 2k and 2k + 1) lies on the rank
    holding row 2k.  An even ``rows`` gives ``rows // 2`` everywhere."""
    if axis is None:
        return (rows // 2,)
    return tuple(-(-(r + 1) * rows // 2) - -(-r * rows // 2)
                 for r in range(axis.size))


def set_rows(counts: tuple) -> None:
    """Make ``counts`` the active axis's layout until the enclosing
    :func:`using_axis` block ends (the rest of a forward after a
    mixup)."""
    _ACTIVE.set(dataclasses.replace(active_data_axis(), rows=tuple(counts)))


def mixup_pairs(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """``x[2k]·λ[2k] + x[2k+1]·λ[2k+1]`` for the mixed rows k this rank
    holds (:func:`mixup_rows`), ``x`` and ``lam`` being the rank's rows of
    the global batch under the active ``data`` axis: both gathered over
    the axis (``x``'s backward sums the ranks' gradients, then keeps the
    rank's rows), then mixed in ``x``'s dtype."""
    axis = active_data_axis()
    rows = x.shape[0]
    if torch.is_grad_enabled() and x.requires_grad:
        xg = _GatherShared.apply(x, axis)
    else:
        xg = _gather(x, axis, 0)
    lg = _gather(lam.contiguous(), axis, 0).to(x.dtype)
    lg = lg.reshape(lg.shape + (1,) * (x.dim() - 1))
    counts = mixup_rows(rows, axis)
    start = sum(counts[:axis.index])
    own = slice(2 * start, 2 * (start + counts[axis.index]))
    xs, ls = xg[own], lg[own]
    return xs[0::2] * ls[0::2] + xs[1::2] * ls[1::2]


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
    def __init__(self, output: dict, layouts: tuple, axis: Axis):
        self._src, self._layouts, self._axis = output, layouts, axis
        # every layout an even split: a tensor's leading dim names its
        # layout on every rank alike
        self._even = all(len(set(c)) == 1 for c in layouts)
        self._read: dict = {}

    def _counts(self, v: torch.Tensor) -> tuple | None:
        """The layout of ``v``'s rows, or None where it has none.  Where
        the ranks' counts differ, the ranks' leading dims are gathered
        first (a rank's own dim could match a layout that another rank's
        does not), so that every rank takes the same decision."""
        rows = v.shape[0]
        if self._even:
            return next((c for c in self._layouts
                         if c[self._axis.index] == rows), None)
        dims = tuple(_gather(torch.tensor([rows], device=v.device),
                             self._axis, 0).tolist())
        return next((c for c in self._layouts if c == dims), None)

    def __getitem__(self, key):
        if key not in self._read:
            v = self._src[key]
            if torch.is_tensor(v) and v.dim() > 0:
                counts = self._counts(v)
                if counts is not None:
                    v = gather_rows(v, self._axis, counts)
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
    entries in the same order).  An entry of ``rows`` may be a tuple of
    every rank's count (:func:`mixup_rows` where they differ)."""
    if axis is None:
        return output
    rows = (rows,) if isinstance(rows, int) else tuple(rows)
    layouts = tuple(tuple(r) if isinstance(r, tuple) else (r,) * axis.size
                    for r in rows)
    return _GlobalOutput(output, layouts, axis)
