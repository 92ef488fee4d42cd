"""Training checkpoints: ``best.pth`` and ``last.pth``, written with
``torch.save``.

Each holds the model's state dict in the reference naming (the layout
``weights.from_jax_variables`` produces, which the JAX package's
``training/torch_import.py:import_biencoder`` reads), the optimizer and
learning-rate scheduler state, the epoch, the metric monitor, the
not-improved count and ``save_trainable_only``, the runner's setting (the
weak runner's is True, as in the JAX package).  The port has no freeze
masks yet, so every parameter is trainable and the state dict is whole
either way.
"""

from __future__ import annotations

from pathlib import Path

import torch


def save_checkpoint(path: str | Path, model: torch.nn.Module, optimizer,
                    scheduler, epoch: int, metric_monitor: dict,
                    not_improve_cnt: int, include_optim: bool = True,
                    save_trainable_only: bool = False) -> None:
    payload = {
        "model": {k: v.detach().cpu() for k, v in
                  model.state_dict().items()},
        "epoch": epoch,
        "metric_monitor": metric_monitor,
        "not_improve_cnt": not_improve_cnt,
        "save_trainable_only": save_trainable_only,
    }
    if include_optim:
        payload["optimizer"] = optimizer.state_dict()
        payload["lr_scheduler"] = scheduler.state_dict()
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
