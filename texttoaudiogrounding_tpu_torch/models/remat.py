"""Rematerialization: a part of the train forward whose activations are
recomputed in the backward instead of kept.

The port of the JAX package's two switches: ``trainer.remat`` wraps the
whole train forward in ``jax.checkpoint`` (``training/runner_base.py:
196-199``) and ``TTG_TRAIN_REMAT`` lists the ``Cnn8Rnn`` conv blocks that
``nn.remat`` wraps (``models/audio_encoder.py:109-119``).  Here
:func:`checkpointed` runs a function under ``torch.utils.checkpoint``
(non-reentrant), so that the step computes what it computes without it:
the same loss, gradients, running statistics and random masks.
``torch.utils.checkpoint`` alone would not, for three reasons, each met
here:

* the masks (dropout, SpecAugment) come from the modules' own
  ``torch.Generator`` s, which its ``preserve_rng_state`` does not know:
  the generators' states at the forward are restored for the recompute,
  and put back as they were after it;
* the train-mode BatchNorms move their running statistics in the forward:
  :func:`recomputing` is true during the recompute, and
  ``layers.update_running`` then leaves them;
* the recompute runs in the backward, outside the ``data`` axis the
  forward ran under (``parallel/kernel_shard.py``): the axis, and its row
  layout, are set again for it, so that the global BatchNorm sums and the
  gathers of the recompute reach the same collectives on every rank, in
  the forward's order.

The hand-written kernels' ``autograd.Function`` s (rows 1, 11, 12, 13)
rerun their forward kernels in the recompute; their saved tensors are
the same function of the same inputs, so they match.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils.checkpoint import checkpoint

from texttoaudiogrounding_tpu_torch.parallel import kernel_shard

_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar(
    "ttg_torch_recomputing", default=False)


def recomputing() -> bool:
    """True inside the backward's recompute of a :func:`checkpointed`
    function."""
    return _RECOMPUTING.get()


def _generator_owners(module: torch.nn.Module) -> list:
    """``module`` and its submodules that draw from a generator of their
    own (``layers.Seeded``)."""
    return [m for m in module.modules() if hasattr(m, "_dropout_generator")]


def _states(owners: list) -> list:
    """Each owner's generator and its state (None: no generator yet)."""
    return [(m._generator, None if m._generator is None
             else m._generator.get_state()) for m in owners]


def _set(owners: list, states: list) -> None:
    for m, (gen, state) in zip(owners, states):
        if state is None:
            m._generator = None
        else:
            m._generator = gen
            gen.set_state(state)


def checkpointed(module: torch.nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant): its generators draw the
    same masks in the recompute, the running statistics move once, and
    the recompute runs under the ``data`` axis the forward ran under."""
    owners = _generator_owners(module)
    axis = kernel_shard.active_data_axis()
    at_forward: list = []

    @contextlib.contextmanager
    def forward_ctx():
        at_forward[:] = _states(owners)
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        after = _states(owners)
        _set(owners, at_forward)
        flag = _RECOMPUTING.set(True)
        try:
            with kernel_shard.using_axis(axis):
                yield
        finally:
            _RECOMPUTING.reset(flag)
            _set(owners, after)

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (forward_ctx(), recompute_ctx()))
