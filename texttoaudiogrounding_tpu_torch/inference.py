"""Batched text-to-audio grounding inference: the public serving API.

Port of ``texttoaudiogrounding_tpu/inference.py:28-235``
(``GroundingPredictor``; reference models/hf_modeling_grounding.py:
338-352): ``predict(audio [B, N], audio_len [B], text List[str]) → frame
probabilities [B, T]`` at 40 ms resolution, tokenization inside, audio
padded to a multiple of ``audio_bucket`` samples, token ids to a multiple
of ``text_bucket``, and the batch split into bucket-sized sub-batches
(padded by repeating the last clip, trimmed afterwards); padded frames
are zeroed.  The model runs on its own device (the card by default).
``GroundingPredictor.from_experiment`` builds one from a training run's
directory (``config.json`` and a checkpoint).  :func:`run_inference` is
the command line's single-clip inference (JAX ``inference.py:238-278``):
a WAV file and a phrase → segments, printed, and a probability plot where
matplotlib imports.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.evaluation.decode import (
    find_contiguous_regions,
    median_filter,
)
from texttoaudiogrounding_tpu_torch.training.train_state import (
    checkpoint_path,
    load_checkpoint,
    load_weights,
)
from texttoaudiogrounding_tpu_torch.utils.config import load_config
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def pad_batch(batch: dict, target: int) -> dict:
    """Pad every batch-major array to ``target`` rows by repeating the
    last row."""
    out = {}
    for key, value in batch.items():
        extra = target - value.shape[0]
        out[key] = (np.concatenate([value, np.repeat(value[-1:], extra, 0)])
                    if extra > 0 else value)
    return out


class GroundingPredictor:
    def __init__(self, model, tokenizer, time_resolution: float = 0.04,
                 audio_bucket: int = 32000, text_bucket: int = 4,
                 batch_buckets: tuple = (1, 8, 16, 32, 64, 128)):
        """``batch_buckets``: incoming batches are split into sub-batches —
        chunks of the largest bucket while the rest exceeds it, then one
        chunk padded up to the smallest bucket that covers the rest.
        Pass ``()`` to run exact incoming sizes."""
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.time_resolution = time_resolution
        self.audio_bucket = audio_bucket
        self.text_bucket = text_bucket
        self.batch_buckets = tuple(sorted(batch_buckets or ()))

    @classmethod
    def from_experiment(cls, experiment_path, which: str = "best",
                        batch_buckets: tuple | None = None,
                        device="cuda") -> "GroundingPredictor":
        """The model of ``experiment_path/config.json`` on ``device`` (the
        card unless the CPU is asked for) with the ``which`` checkpoint's
        weights, the training collate's tokenizer and the training
        dataset's time resolution (JAX ``inference.py:90``).
        ``batch_buckets``: as ``__init__``'s; None takes the config's
        ``inference_args.batch_buckets``, else the default."""
        exp_dir = Path(experiment_path)
        config = load_config(exp_dir / "config.json")
        model = instantiate(config["model"], device=resolve_device(device))
        load_weights(model, load_checkpoint(checkpoint_path(exp_dir, which)),
                     log_fn=lambda *_: None)
        train = config["data"]["train"]
        tokenizer = instantiate(train["collate_fn"]["args"]["tokenizer"])
        inference_args = config.get("inference_args", {})
        time_res = train["dataset"]["args"].get(
            "time_resolution", inference_args.get("time_resolution", 0.04))
        if batch_buckets is None:
            batch_buckets = inference_args.get("batch_buckets")
        kwargs = {} if batch_buckets is None else {
            "batch_buckets": tuple(batch_buckets)}
        return cls(model, tokenizer, time_resolution=time_res, **kwargs)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def _forward(self, chunk: dict) -> dict:
        dev = self.device
        batch = {
            "waveform": torch.from_numpy(chunk["waveform"]).to(dev),
            "waveform_len": torch.from_numpy(chunk["waveform_len"]).to(dev),
            "text": torch.from_numpy(chunk["text"]).to(dev),
            "text_len": torch.from_numpy(chunk["text_len"]).to(dev),
        }
        return self.model(batch)

    def predict(self, audio: np.ndarray, audio_len, text: List[str],
                return_length: bool = False):
        """``audio [B, N]``, ``audio_len [B]``, ``text`` (B strings) →
        frame probabilities ``[B, T]`` (padded frames zeroed); with
        ``return_length`` also the valid frame counts ``[B]``."""
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        audio_len = np.asarray(audio_len, np.int64).reshape(-1)
        pad_n = round_up(audio.shape[1], self.audio_bucket)
        audio = np.pad(audio, ((0, 0), (0, pad_n - audio.shape[1])))
        tokens = self.tokenizer(list(text))
        text_ids = tokens["text"]
        pad_l = round_up(text_ids.shape[1], self.text_bucket)
        text_ids = np.pad(text_ids, ((0, 0), (0, pad_l - text_ids.shape[1])))
        batch = {
            "waveform": audio,
            "waveform_len": audio_len,
            "text": text_ids.astype(np.int64),
            "text_len": np.asarray(tokens["text_len"], np.int64),
        }
        # MultiText models expect a phrase axis: [B, L] -> [B, 1, L]
        if hasattr(self.model, "text_forward_keys"):
            batch["text"] = batch["text"][:, None]
            batch["text_len"] = batch["text_len"][:, None]
        sims, lens = [], []
        for start, size, target in self._chunk_plan(audio.shape[0]):
            chunk = {k: v[start:start + size] for k, v in batch.items()}
            out = self._forward(pad_batch(chunk, target))
            frame_sim = out["frame_sim"][:size].float().cpu().numpy()
            if frame_sim.ndim == 3:     # [B, T, phrases]: the one phrase
                frame_sim = frame_sim[..., 0]
            sims.append(frame_sim)
            lens.append(out["length"][:size].cpu().numpy())
        frame_sim = np.concatenate(sims)
        lengths = np.concatenate(lens)
        mask = np.arange(frame_sim.shape[1])[None] < lengths[:, None]
        masked = frame_sim * mask
        if return_length:
            return masked, lengths
        return masked

    def _chunk_plan(self, b: int) -> list[tuple[int, int, int]]:
        """(start, size, padded_target) sub-batches of a ``b``-row batch."""
        if not self.batch_buckets:
            return [(0, b, b)]
        largest = self.batch_buckets[-1]
        plan = []
        start = 0
        while b - start > largest:
            plan.append((start, largest, largest))
            start += largest
        rest = b - start
        bigger = [x for x in self.batch_buckets if x >= rest]
        plan.append((start, rest, bigger[0] if bigger else largest))
        return plan

    def ground(self, audio: np.ndarray, audio_len, text: List[str],
               threshold: float = 0.5, window_size: int = 1
               ) -> list[list[tuple[float, float]]]:
        """Decode per-clip (onset, offset) second segments."""
        probs, lengths = self.predict(audio, audio_len, text,
                                      return_length=True)
        results = []
        for prob, n in zip(probs, lengths):
            n = max(int(n), 1)
            filtered = median_filter(prob[None, :n], window_size=window_size,
                                     threshold=threshold)[0]
            segs = find_contiguous_regions(filtered) * self.time_resolution
            results.append([tuple(map(float, row)) for row in segs])
        return results


def run_inference(experiment_path, audio: str, phrase: str,
                  output: Optional[str] = None, sample_rate: int = 32000,
                  threshold: float = 0.5, which: str = "best",
                  device="cuda") -> list:
    """Single-clip inference (reference python_scripts/inference/
    inference.py:90-163): the WAV file ``audio`` at ``sample_rate``
    against ``phrase`` through the run's ``which`` checkpoint on
    ``device`` (the card unless the CPU is asked for); the frames
    thresholded at ``threshold`` and decoded into ``[onset, offset]``
    seconds, printed and returned.  ``output`` names a PNG of the
    probabilities, written where matplotlib imports (else it says so)."""
    from texttoaudiogrounding_tpu_torch.data.h5io import load_wav

    predictor = GroundingPredictor.from_experiment(experiment_path,
                                                   which=which, device=device)
    waveform = load_wav(audio, sample_rate)
    duration = waveform.shape[0] / sample_rate
    probs, lengths = predictor.predict(waveform[None], [waveform.shape[0]],
                                       [phrase], return_length=True)
    prob = probs[0][:max(int(lengths[0]), 1)]

    filtered = median_filter(prob[None, :], window_size=1,
                             threshold=threshold)[0]
    segments = [[row[0] * predictor.time_resolution,
                 row[1] * predictor.time_resolution]
                for row in find_contiguous_regions(filtered)]
    print(segments)

    if output is not None:
        try:
            import matplotlib
        except ImportError:
            print(f"matplotlib does not import: {output} not written")
            return segments
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure(figsize=(14, 5))
        plt.plot(prob)
        plt.axhline(y=threshold, color="r", linestyle="--")
        xlabels = [f"{x:.2f}" for x in np.arange(0, duration, duration / 5)]
        plt.xticks(ticks=np.arange(0, len(prob), len(prob) / 5),
                   labels=xlabels, fontsize=15)
        plt.xlabel("Time / second", fontsize=14)
        plt.ylabel("Probability", fontsize=14)
        plt.ylim(0, 1)
        out_path = Path(output)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        plt.savefig(out_path, bbox_inches="tight", dpi=150)
        plt.close()
    return segments
