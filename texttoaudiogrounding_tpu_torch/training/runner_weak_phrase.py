"""Phrase-level WSTAG training: clip-level BCE on ``clip_sim [B, N]``, and
its self-supervised form.

Port of ``texttoaudiogrounding_tpu/training/runner_weak_phrase.py:24-163``
(reference python_scripts/training/run_weak_phrase.py and
run_weak_phrase_self_supervision.py): the strong runner's
loop over ``MultiTextBiEncoder`` and ``AudioSamplePhrasesDataset`` batches,
with the batch's supervision merged into the model output and a guard
that zeroes the gradients of a step whose loss is not finite.  Evaluation
(``configs/weak_phrase/eval.yaml``) is the strong runner's on
single-phrase items: the text gets a phrase axis of 1 and ``frame_sim``
is read at ``[:, :, 0]`` (reference run_weak_phrase.py:48-50).
:class:`WeakPhraseSelfSupervisionRunner` trains against a frozen
teacher's outputs.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.training.runner_strong import StrongRunner
from texttoaudiogrounding_tpu_torch.training.train_state import (
    load_checkpoint,
    load_weights,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate


def weak_output_transform(output: dict, batch: dict) -> dict:
    """The batch's entries (``label`` and the rest) with the model output
    over them (reference ``output.update(batch)``, run_weak_phrase.py:54)."""
    return {**batch, **output}


class WeakPhraseRunner(StrongRunner):
    """``WeakPhraseRunner(device).train(config)`` for the
    ``configs/weak_phrase`` training configs."""

    output_transform = staticmethod(weak_output_transform)
    save_trainable_only = True

    def post_grad_hook(self, loss: torch.Tensor, grads: list) -> None:
        """The NaN guard (reference run_weak_phrase.py:88-93): a loss that
        is not finite zeroes every gradient, on the device, with no host
        synchronisation.  The optimizer still steps, as optax's Adam does
        in the JAX package: the moments decay and the step counts."""
        finite = torch.isfinite(loss)
        for g in grads:
            g.copy_(torch.where(finite, g, torch.zeros_like(g)))

    def eval_batch(self, batch: dict, model) -> dict:
        """The batch on the device with the phrase axis of 1 inserted in
        the model's text keys: ``[B, L]`` → ``[B, 1, L]``."""
        out = to_device(batch, self.device)
        for key in getattr(model, "text_forward_keys", ("text", "text_len")):
            if key in out:
                out[key] = out[key][:, None]
        return out

    def _train_time_resolution(self) -> float:
        """``inference_args.time_resolution`` (the eval config's), else the
        training dataset's, else 0.04."""
        cfg = self.config.get("inference_args", {})
        if "time_resolution" in cfg:
            return cfg["time_resolution"]
        return super()._train_time_resolution()


class WeakPhraseSelfSupervisionRunner(WeakPhraseRunner):
    """WSTAG against a frozen teacher (reference
    run_weak_phrase_self_supervision.py:24-50; the self-supervision config
    ``configs/weak_phrase/cnn8rnn_w2vmean_clustering_selfsup.yaml``).

    The teacher is built from ``config["teacher"]`` and loaded from
    ``teacher["checkpoint"]`` only, as in the JAX runner
    (``runner_weak_phrase.py:113``): a trainable-only checkpoint merges
    over the teacher's own init.  The shipped config names
    ``teacher.pretrained``, which neither package reads: with no
    ``checkpoint`` the teacher keeps its fresh init, here PyTorch's, which
    differs in its numbers from the JAX runner's ``PRNGKey(0)`` init.  The
    teacher runs in eval mode under ``torch.no_grad()``, in the train and
    validation steps alike; it is neither in the optimizer nor in a
    checkpoint.  Each step's output is the batch under the student's
    output with ``label = max(label, teacher clip_sim)`` and
    ``frame_label = teacher frame_sim`` (``ClipFrameBceLoss``'s keys in the
    config).  On several ranks each rank's teacher runs on the rank's rows
    with rank 0's weights (broadcast once built), and the loss gathers the
    fields it overwrote with the student's output (``BaseRunner._global``).
    """

    def build_teacher(self) -> torch.nn.Module:
        cfg = self.config["teacher"]
        teacher = instantiate(cfg, device=self.device)
        if cfg.get("checkpoint") is not None:
            load_weights(teacher, load_checkpoint(cfg["checkpoint"]),
                         self.logger.info)
            self.logger.info(f"teacher loaded from {cfg['checkpoint']}")
        else:
            self.logger.info("teacher: no checkpoint key, fresh init")
        if self.mesh is not None:
            self.mesh.broadcast_module(teacher)
        teacher.eval()
        teacher.requires_grad_(False)
        return teacher

    @staticmethod
    def teacher_transform(teacher: torch.nn.Module):
        """The step's output transform over ``teacher``."""
        def output_transform(output: dict, batch: dict) -> dict:
            with torch.no_grad():
                t_out = teacher(batch)
            return {**batch, **output,
                    "label": torch.maximum(batch["label"], t_out["clip_sim"]),
                    "frame_label": t_out["frame_sim"]}
        return output_transform

    def train_transform(self):
        self.teacher = self.build_teacher()
        return self.teacher_transform(self.teacher)
