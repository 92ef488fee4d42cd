"""Strongly-supervised grounding: frame-BCE training.

Port of ``texttoaudiogrounding_tpu/training/runner_strong.py:37-91``
(reference python_scripts/training/run_strong.py).  The ``evaluate*``
entry points need the port of ``evaluation/`` (PSDS, th-AUC) and are not
here yet.
"""

from __future__ import annotations

from pathlib import Path

import torch

from texttoaudiogrounding_tpu_torch.training.runner_base import BaseRunner


def strong_output_transform(output: dict, batch: dict) -> dict:
    """Cut ``frame_sim`` and ``label`` to a common length and clamp the
    lengths to ``[1, T]`` (reference run_strong.py:107-118)."""
    frame_sim = output["frame_sim"]
    label = batch["label"].to(frame_sim.dtype)
    t = min(frame_sim.shape[1], label.shape[1])
    length = torch.clamp(output["length"], 1, t)
    return {**output, "frame_sim": frame_sim[:, :t], "label": label[:, :t],
            "length": length}


class StrongRunner(BaseRunner):
    """``StrongRunner(device).train(config)``: ``config`` is a dict or a
    YAML path (PyYAML needed), the data are HDF5 files (h5py needed)."""

    output_transform = staticmethod(strong_output_transform)

    def train(self, config) -> Path:
        self.setup(config)
        exp_dir = self.prepare_experiment()
        train_loader = self.build_dataloader(self.config["data"]["train"],
                                             shuffle=True)
        val_loader = self.build_dataloader(self.config["data"]["val"],
                                           shuffle=False)
        model = self.build_model()
        loss_fn = self.build_loss()
        self.fit(model, loss_fn, train_loader, val_loader,
                 self.output_transform, exp_dir)
        return exp_dir
