"""The device mesh of a run, its batch sharding and its parameter rules.

Port of ``texttoaudiogrounding_tpu/parallel/mesh.py:23-186``.  PyTorch
runs one process a card, so the port's mesh is one over the ranks of the
process group (``torchrun``, or a group the caller initialized): a
``torch.distributed.device_mesh.DeviceMesh`` with the ``parallel.mesh``
block's axes in its order, the ranks laid out row-major as JAX lays out
its devices.

* :func:`mesh_from_config`: ``parallel: {mesh: {data: N, model: M}}``
  (``data: -1`` takes the ranks that remain); no block puts every rank on
  ``data``.  A mesh that needs more ranks than the world raises JAX's
  error; so does one that needs fewer, since the port has no idle ranks
  (JAX takes the first devices and leaves the rest idle).  A world of one
  process without a group is the one-rank mesh.
* :func:`pad_batch_to_multiple`: JAX's padding, bit for bit (the last row
  repeated); training pads to the whole mesh, data x model, as JAX pads to
  ``mesh.devices.size``.
* :func:`shard_batch`: the rank's contiguous rows of the ``data`` axis; a
  leaf whose leading dim does not divide the axis stays whole, as JAX
  replicates it, and so do the flat phrases of a ``VarNumTextCollate``
  batch (:func:`ragged_keys`: rows that are not batch items, which JAX's
  global step indexes by ``{key}_pad_index``) and the keys a model takes
  whole on every rank (``whole``: the alignment models' text side).
* :func:`param_placements`: ``parallel.rules`` on the port's parameters by
  the JAX flax paths ``weights.flax_leaf`` gives them, the spec moved to
  the torch layout where ``weights.py`` transposes; the first rule that
  fits wins, and a dim that does not divide its axis falls back to
  replication (JAX ``sharding_rules_fn``).
* :func:`device_feed`: the host batches padded, cut to the rank's rows and
  copied to the card from pinned memory without blocking.  JAX's
  ``ProducerThread`` has no counterpart: the port's loader is PyTorch's
  ``DataLoader``, whose worker processes already prepare batches ahead.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import Axis
from texttoaudiogrounding_tpu_torch.weights import flax_leaf


class Mesh:
    """Named axes over the process group's ranks (row-major).  ``shape``
    maps each axis to its size in the config's order; ``device_mesh`` is
    the ``DeviceMesh`` (None for one process without a group)."""

    def __init__(self, shape: dict, device_mesh=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        """Ranks in the mesh (JAX ``mesh.devices.size``)."""
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.device_mesh is not None else 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def axis_size(self, name: str) -> int:
        return int(self.shape.get(name, 1))

    def axis(self, name: str) -> Axis | None:
        """The rank's view of axis ``name``; None where it has size 1."""
        if self.axis_size(name) <= 1:
            return None
        return Axis(self.device_mesh.get_group(name), self.axis_size(name),
                    self.device_mesh.get_local_rank(name))

    def coordinate(self, name: str) -> int:
        axis = self.axis(name)
        return 0 if axis is None else axis.index

    def barrier(self) -> None:
        if self.device_mesh is not None:
            dist.barrier()

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers of ``module`` on every rank (a
        module that no ``parallel.rules`` shard)."""
        if self.device_mesh is None:
            return
        with torch.no_grad():
            for tensor in module.state_dict().values():
                dist.broadcast(tensor, src=0)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def mesh_shape(parallel_cfg: Optional[dict], world: int) -> dict:
    """``{axis: size}`` of a ``parallel:`` block over ``world`` ranks."""
    if not parallel_cfg or "mesh" not in parallel_cfg:
        return {"data": world}
    spec = dict(parallel_cfg["mesh"])
    sizes = list(spec.values())
    if -1 in sizes:
        rest = int(np.prod([s for s in sizes if s != -1]))
        sizes = [world // rest if s == -1 else s for s in sizes]
    total = int(np.prod(sizes))
    if total > world:
        raise ValueError(f"parallel.mesh {spec} needs {total} devices, "
                         f"have {world}")
    if total < world:
        raise ValueError(f"parallel.mesh {spec} needs {total} devices, "
                         f"have {world}: the port runs one process a rank "
                         "and leaves none idle; start as many ranks as the "
                         "mesh holds")
    return dict(zip(spec, (int(s) for s in sizes)))


def init_distributed(device) -> None:
    """Initialize the default process group from ``torchrun``'s environment
    (NCCL for the card, gloo for the CPU) unless one exists already or no
    launcher set ``WORLD_SIZE``."""
    if not dist.is_available() or dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend)


def mesh_from_config(parallel_cfg: Optional[dict], device="cpu") -> Mesh:
    """The run's mesh over the process group's ranks (see the module's
    docstring); ``device`` names the backend a launcher's group gets."""
    init_distributed(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(mesh_shape(parallel_cfg, 1))
    from torch.distributed.device_mesh import DeviceMesh

    shape = mesh_shape(parallel_cfg, dist.get_world_size())
    ranks = torch.arange(dist.get_world_size()).reshape(
        tuple(shape.values()))
    return Mesh(shape, DeviceMesh(torch.device(device).type, ranks,
                                  mesh_dim_names=tuple(shape)))


def ragged_keys(batch: dict) -> set:
    """The flat keys of ``VarNumTextCollate``'s ragged groups: ``{key}
    [ΣN, L]`` and ``{key}_len [ΣN]`` for each ``{key}_pad_index``.  Their
    rows are phrases, not batch items: the feed neither pads nor cuts them
    (each rank gets every phrase, and ``{key}_pad_index`` keeps its global
    indices into them)."""
    out = set()
    for name in batch:
        key = name[:-len("_pad_index")]
        if name.endswith("_pad_index") and key in batch:
            out |= {key, f"{key}_len"}
    return out


def pad_batch_to_multiple(batch: dict, multiple: int) -> tuple[dict, int]:
    """Pad the batch dim so it divides the mesh (last partial batches).

    Returns (padded_batch, real_batch_size).  Padding repeats the last
    element; callers mask out padded rows on the host after the step.
    The flat keys of a ragged phrase group (:func:`ragged_keys`) are not
    rows and stay as they are.
    """
    ragged = ragged_keys(batch)
    leaves = [v for k, v in batch.items() if k not in ragged
              and isinstance(v, np.ndarray) and v.ndim > 0]
    if not leaves:
        return batch, 0
    b = leaves[0].shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return batch, b
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.ndim > 0 \
                and value.shape[0] == b and key not in ragged:
            out[key] = np.concatenate(
                [value, np.repeat(value[-1:], target - b, axis=0)], axis=0)
        else:
            out[key] = value
    return out, b


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data",
                whole: Iterable = ()) -> dict:
    """The rank's contiguous rows of every array leaf whose leading dim
    divides ``axis``; other leaves (ids, strings), the flat keys of a
    ragged phrase group (:func:`ragged_keys`) and the keys in ``whole``
    (inputs every rank takes whole: the text side of the alignment
    models, ``whole_batch_inputs``) as they are."""
    n = mesh.axis_size(axis)
    if n <= 1:
        return batch
    index = mesh.coordinate(axis)
    keep = ragged_keys(batch) | set(whole)
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.ndim > 0 \
                and value.shape[0] % n == 0 and key not in keep:
            rows = value.shape[0] // n
            out[key] = value[index * rows:(index + 1) * rows]
        else:
            out[key] = value
    return out


def rank_batch(batch: dict, mesh: Mesh, whole: Iterable = ()
               ) -> tuple[dict, int]:
    """``(the rank's rows of batch padded to the mesh's ranks, the real
    batch size)``: :func:`pad_batch_to_multiple`, then
    :func:`shard_batch`."""
    arr, real = pad_batch_to_multiple(batch, mesh.size)
    return shard_batch(arr, mesh, whole=whole), real


def device_feed(batches: Iterable, mesh: Mesh, device,
                prepare: Optional[Callable] = None, whole: Iterable = ()
                ) -> Iterator[tuple[dict, dict, int]]:
    """``(the rank's batch on device, host batch, real batch size)`` for
    each host batch: ``prepare`` (default none), padded to a multiple of
    the mesh's ranks, the rank's rows (``whole`` keys kept whole), pinned
    and copied without blocking (JAX ``device_feed``)."""
    for host_batch in batches:
        local, real_bs = rank_batch(
            prepare(host_batch) if prepare else host_batch, mesh, whole)
        yield to_device(local, device, pin=True), host_batch, real_bs


def _spec(rule_spec) -> tuple:
    return tuple(None if s in (None, "null") else s for s in rule_spec)


def _axes(ax) -> tuple:
    return ax if isinstance(ax, (tuple, list)) else (ax,)


def param_placements(model: torch.nn.Module, mesh_shape_: dict,
                     rules: Optional[list]) -> dict:
    """``{parameter name: spec over its torch dims}`` for each parameter
    that ``rules`` shard on ``mesh_shape_`` (``{axis: size}``); the
    replicated ones are left out (JAX ``sharding_rules_fn`` through
    ``weights.flax_leaf``)."""
    compiled = [(tuple(r["match"]), _spec(r["spec"])) for r in rules or []]
    out = {}
    for name, p in model.named_parameters():
        if p.dim() == 0:
            continue
        paths, perm = flax_leaf(model, name)
        for tokens, spec in compiled:
            if not any(all(tok in path for tok in tokens) for path in paths):
                continue
            if perm is None:
                if any(ax is not None for ax in spec):
                    raise NotImplementedError(
                        f"parallel.rules shard {name}, whose layout the "
                        "port does not map from the JAX tree")
                break
            flax_shape = tuple(p.shape[perm.index(i)]
                               for i in range(p.dim()))
            if len(spec) > p.dim() or not all(
                    ax is None or flax_shape[i] % int(np.prod(
                        [mesh_shape_.get(a, 1) for a in _axes(ax)])) == 0
                    for i, ax in enumerate(spec)):
                continue
            if any(ax is not None for ax in spec):
                full = spec + (None,) * (p.dim() - len(spec))
                out[name] = tuple(full[perm[d]] for d in range(p.dim()))
            break
    return out
