"""Similarity poolings: ``sim [B, B, T, N]`` → ``[B, B]``, and the
multi-text ``sim [B, T, N]`` → ``[B, N]``.

Port of ``texttoaudiogrounding_tpu/models/sim_pooling.py`` (reference
models/sim_pooling.py:6-204): one module pools the audio axis (dim 2,
``audio_len`` of the audio item, dim 0) and then the text axis (dim 3,
``text_len`` of the text item, dim 1) with the masked poolings of
``ops/masking.py``; each reference class name builds it preconfigured
(:data:`SIM_POOLINGS`, :data:`MULTI_TEXT_POOLINGS`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from texttoaudiogrounding_tpu_torch.ops import masking

AUDIO_POOLS = {"mean": masking.mean_with_lens, "max": masking.max_with_lens,
               "linear_softmax": masking.linear_softmax_with_lens,
               "exp_softmax": masking.exp_softmax_with_lens}
TEXT_POOLS = {"mean": masking.mean_with_lens, "sum": masking.sum_with_lens,
              "max": masking.max_with_lens}


def _mean_sum(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    return masking.sum_with_lens(x, lens) + masking.mean_with_lens(x, lens)


class SimPooling(nn.Module):
    """Pool the audio axis with ``audio_pool``, then the text axis with
    ``text_pool`` (``"mean+sum"``: the sum plus the mean)."""

    def __init__(self, audio_pool: str = "mean", text_pool: str = "mean"):
        super().__init__()
        if audio_pool not in AUDIO_POOLS or text_pool not in (
                *TEXT_POOLS, "mean+sum"):
            raise ValueError(f"unknown pooling {audio_pool} / {text_pool}")
        self.audio_pool, self.text_pool = audio_pool, text_pool

    def forward(self, input_dict: dict) -> torch.Tensor:
        sim = input_dict["sim"]
        b_a, b_t, t, n = sim.shape
        flat = AUDIO_POOLS[self.audio_pool](
            sim.reshape(b_a * b_t, t, n),
            input_dict["audio_len"].repeat_interleave(b_t))     # [B·B, N]
        text_pool = (_mean_sum if self.text_pool == "mean+sum"
                     else TEXT_POOLS[self.text_pool])
        return text_pool(flat, input_dict["text_len"].repeat(b_a)).reshape(
            b_a, b_t)


class MultiTextPooling(nn.Module):
    """``sim [B, T, N]`` pooled over the audio axis → ``[B, N]``."""

    def __init__(self, pool: str = "linear_softmax"):
        super().__init__()
        self.pool = pool

    def forward(self, input_dict: dict) -> torch.Tensor:
        return AUDIO_POOLS[self.pool](input_dict["sim"],
                                      input_dict["audio_len"])


def _preset(cls, **preset):
    def build(**kwargs):
        return cls(**preset, **kwargs)
    return build


# the reference's class names (models/sim_pooling.py:6-204)
SIM_POOLINGS = {
    name: _preset(SimPooling, audio_pool=a, text_pool=t)
    for name, a, t in (
        ("AudioMeanTextMean", "mean", "mean"),
        ("AudioMeanTextSum", "mean", "sum"),
        ("AudioMaxTextMean", "max", "mean"),
        ("AudioMaxTextMax", "max", "max"),
        ("AudioMaxTextSum", "max", "sum"),
        ("AudioMaxTextMeanSum", "max", "mean+sum"),
        ("AudioLinearSoftTextMean", "linear_softmax", "mean"),
        ("AudioLinearSoftTextSum", "linear_softmax", "sum"),
        ("AudioExpSoftTextMean", "exp_softmax", "mean"),
        ("AudioExpSoftTextSum", "exp_softmax", "sum"))}
MULTI_TEXT_POOLINGS = {
    "MultiTextLinearSoft": _preset(MultiTextPooling, pool="linear_softmax"),
    "MultiTextMax": _preset(MultiTextPooling, pool="max")}
