"""Optimizer, freeze masks, gradient clipping, learning-rate plateau, early
stopping.

Port of ``texttoaudiogrounding_tpu/training/optim.py:33-257``.  The JAX
package chains ``optax.clip_by_global_norm`` before ``optax.adam``;
:class:`Optimizer` does the same around ``torch.optim.Adam``, clipping by
optax's formula: with ``norm = sqrt(Σ g²)`` over every gradient, each
gradient becomes ``g / norm * max_norm`` when ``norm >= max_norm`` and is
left as it is otherwise (``torch.nn.utils.clip_grad_norm_`` scales by
``max_norm / (norm + 1e-6)``).  A model's freeze flags become a mask
(:func:`freeze_mask_from_model`, JAX ``:33-72``); the JAX package wraps
the chain in ``optax.masked`` and zeroes the frozen updates, so the norm
is taken over the trainable parameters only, Adam keeps no state for the
frozen ones and they never move: here the :class:`Optimizer` gets the
trainable parameters alone (:func:`trainable_parameters`).
:class:`ReduceLROnPlateau` and :class:`MetricImprover` are copies of the
JAX ones, so the two packages take the same decisions on the same losses.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def freeze_mask_from_model(model: torch.nn.Module) -> dict | None:
    """``{parameter name: trainable}`` from the model's freeze flags, or
    None when nothing is frozen (JAX ``optim.py:33-72``, on the port's
    dotted names):

    * ``freeze_audio_encoder`` / ``freeze_text_encoder`` (the bi-encoders'
      flags): everything under that tower;
    * ``audio_encoder.freeze_cnn``: everything under the audio encoder but
      its ``rnn`` (``bn0`` and ``fc1`` included), the exception winning
      over every other rule;
    * ``text_encoder.freeze_embedding``: the embedding table only."""
    prefixes: list[tuple[str, ...]] = []
    exceptions: list[tuple[str, ...]] = []
    if getattr(model, "freeze_audio_encoder", False):
        prefixes.append(("audio_encoder",))
    if getattr(model, "freeze_text_encoder", False):
        prefixes.append(("text_encoder",))
    audio_enc = getattr(model, "audio_encoder", model)
    if getattr(audio_enc, "freeze_cnn", False):
        prefixes.append(("audio_encoder",))
        exceptions.append(("audio_encoder", "rnn"))
    text_enc = getattr(model, "text_encoder", None)
    if text_enc is not None and getattr(text_enc, "freeze_embedding", False):
        prefixes.append(("text_encoder", "embedding"))
    if getattr(model, "freeze_embedding", False):
        prefixes.append(("embedding",))
    if not prefixes:
        return None

    def trainable(names: tuple) -> bool:
        if any(names[:len(exc)] == exc for exc in exceptions):
            return True
        return not any(names[:len(pre)] == pre for pre in prefixes)

    return {name: trainable(tuple(name.split(".")))
            for name, _ in model.named_parameters()}


def trainable_parameters(model: torch.nn.Module, mask: dict | None) -> list:
    """The parameters ``mask`` keeps trainable (all when None); the frozen
    ones get ``requires_grad = False``, so that no gradient is computed or
    kept for them."""
    out = []
    for name, p in model.named_parameters():
        if mask is None or mask[name]:
            out.append(p)
        else:
            p.requires_grad_(False)
    return out


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place, without a host synchronisation; returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """``{"type": "Adam", "args": {"lr": ...}}`` over ``params``, preceded
    by global-norm clipping when ``max_grad_norm`` is set."""

    def __init__(self, config: dict, params, max_grad_norm: float | None):
        if config.get("type", "Adam") != "Adam":
            raise KeyError(f"unknown optimizer {config['type']}")
        self.params = [p for p in params if p.requires_grad]
        self.max_grad_norm = max_grad_norm
        self.inner = torch.optim.Adam(self.params, **config.get("args", {}))

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.max_grad_norm is not None:
            clip_by_global_norm_(self.params, self.max_grad_norm)
        self.inner.step()

    @property
    def lr(self) -> float:
        return float(self.inner.param_groups[0]["lr"])

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.inner.param_groups:
            group["lr"] = value

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Adam's moments, step counts and learning rate, moved to the
        parameters' device."""
        self.inner.load_state_dict(state)


class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau``'s rule as the JAX package applies it:
    multiply the rate by ``factor`` after ``patience`` epochs without a
    relative improvement of ``threshold``."""

    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 min_lr: float = 0.0):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.lr: float | None = None

    def _is_better(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, metric: float, lr: float) -> float:
        self.lr = lr
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            self.lr = max(lr * self.factor, self.min_lr)
        return self.lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "lr": self.lr}

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
        self.lr = state["lr"]


class MetricImprover:
    """Early-stopping monitor (reference utils/train_util.py:326-346)."""

    def __init__(self, mode: str):
        if mode not in ("min", "max"):
            raise ValueError("mode is 'min' or 'max'")
        self.mode = mode
        self.best_value = np.inf if mode == "min" else -np.inf

    def __call__(self, value: float) -> bool:
        better = (value < self.best_value if self.mode == "min"
                  else value > self.best_value)
        if better:
            self.best_value = value
        return bool(better)

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)
