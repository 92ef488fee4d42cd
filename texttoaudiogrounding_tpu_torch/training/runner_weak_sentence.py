"""Sentence-level WSTAG: ranking losses on the ``sim [B, B]`` of the
alignment models.

Port of ``texttoaudiogrounding_tpu/training/runner_weak_sentence.py``
(reference python_scripts/training/run_weak_sentence.py).  Training is the
phrase runner's loop (``configs/weak_sentence/{phrase,word}_wise/``: an
``AudioTextAlignByPhrase`` / ``ByWord`` model, ``MaxMarginRankingLoss``).
Evaluation (``configs/weak_sentence/*/eval.yaml``) runs the forward with
``output_matrix`` and scores each item by the diagonal ``sim_matrix[i,
i]``: a phrase model's first phrase, a word model's words aggregated by
``inference_args.word_aggregation`` (mean, sum or max over the padded
word axis, then clipped to [0, 1]; reference :321-334).  The tracks keep
every frame: unlike the strong runner's they are not cut to the clip's
length, as in the JAX runner.  The shipped phrase-wise eval config
collates the phrase as ``text`` and gives no ``phrases``: its evaluation
raises ``KeyError: 'phrases'`` here as in the JAX package.

On several ranks (``runner_base.py``) every rank takes the batch's
captions whole and computes its audio rows' block ``sim [b, B]`` of the
matrix (``models/align_models.py``); the ranking loss reads the gathered
``[B, B]``, and evaluation the diagonal of the gathered ``sim_matrix``
(``eval_forward``).
"""

from __future__ import annotations

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
    WeakPhraseRunner,
)

_PHRASE_MODELS = ("AudioTextAlignByPhrase", "AudioTextCrossAlignByPhrase")
_AGGREGATIONS = {"mean": np.mean, "sum": np.sum, "max": np.max}


class WeakSentenceRunner(WeakPhraseRunner):
    """``WeakSentenceRunner(device).train(config)`` and ``.evaluate``."""

    def eval_batch(self, batch: dict, model) -> dict:
        return {**to_device(batch, self.device), "output_matrix": True}

    def eval_tracks(self, output: dict, model, batch: dict) -> list:
        diag = torch.diagonal(output["sim_matrix"].float(), dim1=0, dim2=1)
        diag = diag.permute(2, 0, 1).cpu().numpy()            # [B, T, N]
        if type(model).__name__ in _PHRASE_MODELS:
            return list(diag[:, :, 0])
        name = self.config.get("inference_args", {}).get("word_aggregation",
                                                         "mean")
        if name not in _AGGREGATIONS:
            raise ValueError(name)
        return [np.clip(_AGGREGATIONS[name](words, axis=-1), 0.0, 1.0)
                for words in diag]
