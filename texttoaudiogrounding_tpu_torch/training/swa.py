"""Stochastic weight averaging over the parameters and the BatchNorm
statistics.

Port of ``texttoaudiogrounding_tpu/training/swa.py:25-52`` (reference
utils/train_util.py:349-374, an ``AveragedModel`` that also averages
buffers; no shipped runner calls it).  It works on the model's state dict:
every floating tensor, the running statistics among them, and not the
integer ``num_batches_tracked``.  Usage::

    swa = SWAState.create(model)
    ...
    swa.update(model)            # after each epoch past the SWA start
    swa.apply_to(eval_model)     # the average, for evaluation
"""

from __future__ import annotations

import torch


class SWAState:
    def __init__(self, average: dict, n_averaged: int = 0):
        self.average = average
        self.n_averaged = n_averaged

    @classmethod
    def create(cls, model: torch.nn.Module) -> "SWAState":
        """A copy of ``model``'s floating state, not yet averaged (n = 0)."""
        return cls({name: value.detach().clone()
                    for name, value in model.state_dict().items()
                    if value.is_floating_point()})

    def update(self, model: torch.nn.Module) -> "SWAState":
        """The running average ``avg += (new - avg) / (n + 1)``, which
        takes ``model``'s values at n = 0; returns ``self``."""
        n = self.n_averaged
        state = model.state_dict()
        with torch.no_grad():
            for name, avg in self.average.items():
                new = state[name].detach()
                if n == 0:
                    avg.copy_(new)
                else:
                    count = torch.tensor(n + 1, dtype=avg.dtype,
                                         device=avg.device)
                    avg.add_((new - avg) / count)
        self.n_averaged = n + 1
        return self

    def apply_to(self, model: torch.nn.Module) -> torch.nn.Module:
        """Copy the average into ``model`` (in place, so the conv blocks'
        prepared kernel weights are made anew) and return it."""
        model.load_state_dict(self.average, strict=False)
        return model
