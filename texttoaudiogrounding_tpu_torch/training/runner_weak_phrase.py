"""Phrase-level WSTAG training: clip-level BCE on ``clip_sim [B, N]``.

Port of ``texttoaudiogrounding_tpu/training/runner_weak_phrase.py:24-58``
(reference python_scripts/training/run_weak_phrase.py): the strong runner's
loop over ``MultiTextBiEncoder`` and ``AudioSamplePhrasesDataset`` batches,
with the batch's supervision merged into the model output and a guard
that zeroes the gradients of a step whose loss is not finite.  Evaluation
(``configs/weak_phrase/eval.yaml``) is the strong runner's on
single-phrase items: the text gets a phrase axis of 1 and ``frame_sim``
is read at ``[:, :, 0]`` (reference run_weak_phrase.py:48-50).  Not
ported yet: the self-supervision runner.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.training.runner_strong import StrongRunner


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
