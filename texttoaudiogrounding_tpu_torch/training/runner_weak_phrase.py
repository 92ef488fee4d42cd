"""Phrase-level WSTAG training: clip-level BCE on ``clip_sim [B, N]``.

Port of ``texttoaudiogrounding_tpu/training/runner_weak_phrase.py:24-58``
(reference python_scripts/training/run_weak_phrase.py): the strong runner's
loop over ``MultiTextBiEncoder`` and ``AudioSamplePhrasesDataset`` batches,
with the batch's supervision merged into the model output and a guard
that zeroes the gradients of a step whose loss is not finite.  Not ported
yet: ``eval_inference`` (it waits for ``evaluation/``) and the
self-supervision runner (it needs a teacher's checkpoint loaded).
"""

from __future__ import annotations

import torch

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
