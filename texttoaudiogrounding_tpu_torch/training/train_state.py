"""Training checkpoints: ``best.pth`` and ``last.pth``, written with
``torch.save``.

Each holds the model's state dict in the reference naming (the layout
``weights.from_jax_variables`` produces, which the JAX package's
``training/torch_import.py:import_biencoder`` reads), the optimizer and
learning-rate scheduler state, the epoch, the metric monitor, the
not-improved count, ``save_trainable_only`` (the runner's setting: the
weak runner's is True, as in the JAX package) and ``trainables_only``.
With a freeze mask (``training/optim.py``) and ``save_trainable_only`` the
frozen parameters are left out and every buffer kept (JAX
``train_state.py:55-69``): ``trainables_only`` is then True.

:func:`load_checkpoint` reads them back, and a reference-format ``.pth``
(``{"model": state_dict}``, the layout of the JAX package's
``training/torch_import.py:export_biencoder`` and
``save_torch_checkpoint``, or a bare state dict) as weights alone;
:func:`load_weights` puts a checkpoint's weights into a model, merging by
name and shape (:func:`merge_matched_params`) where the checkpoint may
hold only part of the model.
"""

from __future__ import annotations

from pathlib import Path

import torch


def trainable_state_dict(model: torch.nn.Module,
                         trainable_mask: dict | None) -> dict:
    """``model``'s state dict on the CPU, without the parameters that
    ``trainable_mask`` (``{name: trainable}``) freezes; every buffer kept."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()
            if trainable_mask is None or trainable_mask.get(k, True)}


def save_checkpoint(path: str | Path, model: torch.nn.Module, optimizer,
                    scheduler, epoch: int, metric_monitor: dict,
                    not_improve_cnt: int, include_optim: bool = True,
                    save_trainable_only: bool = False,
                    trainable_mask: dict | None = None) -> None:
    """``trainable_mask`` (the freeze mask, passed only with
    ``save_trainable_only``) prunes the frozen parameters."""
    payload = {
        "model": trainable_state_dict(model, trainable_mask),
        "epoch": epoch,
        "metric_monitor": metric_monitor,
        "not_improve_cnt": not_improve_cnt,
        "save_trainable_only": save_trainable_only,
        "trainables_only": trainable_mask is not None,
    }
    if include_optim:
        payload["optimizer"] = optimizer.state_dict()
        payload["lr_scheduler"] = scheduler.state_dict()
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def checkpoint_path(exp_dir: str | Path, which: str = "best") -> Path:
    """``exp_dir/<which>.pth``: ``"best"`` and ``"best.pth"`` both name
    ``best.pth``."""
    name = str(which)
    return Path(exp_dir) / (name if name.endswith(".pth") else f"{name}.pth")


def load_checkpoint(path: str | Path) -> dict:
    """A checkpoint's payload, on the CPU.  A reference-format file comes
    back as ``{"model": state_dict}`` with nothing else."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and isinstance(payload.get("model"), dict):
        return payload
    return {"model": payload}


def merge_matched_params(model: torch.nn.Module, state_dict: dict,
                         log_fn=print) -> list:
    """Load the entries of ``state_dict`` whose name and shape match the
    model's (reference utils/train_util.py:219-248); the model keeps its
    own values for the rest.  Logs and returns the names not loaded."""
    own = model.state_dict()
    matched = {k: v for k, v in state_dict.items()
               if k in own and own[k].shape == v.shape}
    skipped = sorted(set(state_dict) - set(matched))
    kept = sorted(set(own) - set(matched))
    model.load_state_dict(matched, strict=False)
    if skipped or kept:
        log_fn(f"checkpoint entries not loaded (name or shape): {skipped}; "
               f"model entries kept: {kept}")
    return skipped + kept


def load_weights(model: torch.nn.Module, payload: dict, log_fn=print) -> None:
    """A checkpoint's weights into ``model`` (in place: ``copy_`` into the
    existing tensors, so the conv blocks' prepared kernel weights are made
    anew).  Trainable-only and reference-format checkpoints merge by name
    and shape over the model's own values (a trainable-only one over the
    frozen parameters the model already holds: the running model's on
    resume, its fresh init on restore); a whole checkpoint of this package
    must match exactly."""
    if (payload.get("save_trainable_only") or payload.get("trainables_only")
            or "epoch" not in payload):
        merge_matched_params(model, payload["model"], log_fn)
    else:
        model.load_state_dict(payload["model"])
