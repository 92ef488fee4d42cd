"""Optimizer, gradient clipping, learning-rate plateau, early stopping.

Port of ``texttoaudiogrounding_tpu/training/optim.py:76-257``.  The JAX
package chains ``optax.clip_by_global_norm`` before ``optax.adam``;
:class:`Optimizer` does the same around ``torch.optim.Adam``, clipping by
optax's formula: with ``norm = sqrt(Σ g²)`` over every gradient, each
gradient becomes ``g / norm * max_norm`` when ``norm >= max_norm`` and is
left as it is otherwise (``torch.nn.utils.clip_grad_norm_`` scales by
``max_norm / (norm + 1e-6)``).  :class:`ReduceLROnPlateau` and
:class:`MetricImprover` are copies of the JAX ones, so the two packages
take the same decisions on the same losses.
"""

from __future__ import annotations

import math

import numpy as np
import torch



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
