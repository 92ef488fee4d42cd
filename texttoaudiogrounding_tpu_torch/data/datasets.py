"""(audio, phrase) datasets for strong supervision.

Ports of ``texttoaudiogrounding_tpu/data/datasets.py:80-145`` (reference
datasets/single_phrase_dataset.py:20-88) over the same files: a waveform
index (``audio_id<TAB>hdf5_path``) and the grounding label JSON
``[{audiocap_id, audio_id, tokens, phrases: [{phrase, start_index,
end_index, segments: [[on, off], ...]}]}]``.  They are
``torch.utils.data.Dataset``s of numpy items.
"""

from __future__ import annotations

import json
import math

import numpy as np
from torch.utils.data import Dataset

from texttoaudiogrounding_tpu_torch.data.h5io import (
    as_wire,
    load_dict_from_csv,
    read_from_h5,
)


def _load_label(label) -> list:
    """The label JSON's path, or its already loaded list."""
    if isinstance(label, list):
        return label
    with open(label) as f:
        return json.load(f)


class AudioPhraseEvalDataset(Dataset):
    """One item per (audio, phrase) pair."""

    def __init__(self, waveform: str, label, sample_rate: int = 32000):
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        self.sample_rate = sample_rate
        self.idxs = [(ai, pi)
                     for ai, audio_item in enumerate(self.data)
                     for pi, _ in enumerate(audio_item["phrases"])]

    def __getstate__(self):
        # open h5py handles do not pickle; worker processes reopen them
        state = dict(self.__dict__)
        state["cache"] = {}
        return state

    def __getitem__(self, index):
        audio_idx, phrase_idx = self.idxs[index]
        audio_item = self.data[audio_idx]
        phrase_item = audio_item["phrases"][phrase_idx]
        waveform = read_from_h5(audio_item["audio_id"],
                                self.aid_to_h5[audio_item["audio_id"]],
                                self.cache)
        return {
            "audio_id": audio_item["audio_id"],
            "audiocap_id": audio_item["audiocap_id"],
            "start_index": phrase_item["start_index"],
            "end_index": phrase_item["end_index"],
            "waveform": as_wire(waveform),
            "phrase": phrase_item["phrase"],
            "caption": audio_item["tokens"],
        }

    def __len__(self):
        return len(self.idxs)


def frame_labels(n_samples: int, segments, sample_rate: int,
                 time_resolution: float) -> np.ndarray:
    """0/1 frame labels: ``floor(duration / res) + 1`` frames, ones from
    ``round(onset / res)`` up to ``round(offset / res)``."""
    duration = n_samples / sample_rate
    n_frame = math.floor(duration / time_resolution) + 1
    frame_label = np.zeros(n_frame, dtype=np.float32)
    for start, end in segments:
        onset = round(start / time_resolution)
        offset = round(end / time_resolution)
        frame_label[onset:offset] = 1
    return frame_label


class AudioPhraseDataset(AudioPhraseEvalDataset):
    """Adds the rasterized frame labels at ``time_resolution``."""

    def __init__(self, waveform: str, label, time_resolution: float = 0.02,
                 sample_rate: int = 32000):
        super().__init__(waveform, label, sample_rate)
        self.time_resolution = time_resolution

    def __getitem__(self, index):
        output = super().__getitem__(index)
        audio_idx, phrase_idx = self.idxs[index]
        phrase_item = self.data[audio_idx]["phrases"][phrase_idx]
        output["label"] = frame_labels(
            output["waveform"].shape[0], phrase_item["segments"],
            self.sample_rate, self.time_resolution)
        return output
