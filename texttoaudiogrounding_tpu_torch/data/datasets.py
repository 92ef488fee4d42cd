"""Datasets for strong supervision and for phrase- and sentence-level
WSTAG.

Ports of ``texttoaudiogrounding_tpu/data/datasets.py:80-145`` (reference
datasets/single_phrase_dataset.py:20-88), ``:148-378``
(``AudioSamplePhrasesDataset``, reference
datasets/multi_phrase_dataset.py:51-307) and ``:381-558`` (the caption
datasets of sentence-level WSTAG and their evaluation items, reference
datasets/multi_phrase_dataset.py:310-458, caption_dataset.py:11-61) over
the same files: a waveform
index (``audio_id<TAB>hdf5_path`` or ``audio_id<TAB>file_path``), the
grounding label JSON ``[{audiocap_id, audio_id, tokens, phrases:
[{phrase, start_index, end_index, segments: [[on, off], ...]}]}]`` and the
WSTAG caption JSON, whose ``phrases`` are strings.  They are
``torch.utils.data.Dataset``s of numpy items.
"""

from __future__ import annotations

import json
import math
import pickle
from typing import Optional

import numpy as np
from torch.utils.data import Dataset

from texttoaudiogrounding_tpu_torch.data.h5io import (
    AudioReadMixin,
    as_wire,
    load_dict_from_csv,
    read_from_h5,
)


def _load_label(label) -> list:
    """The label JSON's path, a list of such paths (concatenated), or an
    already loaded list."""
    if isinstance(label, list) and label and isinstance(label[0], str):
        data = []
        for item in label:
            with open(item) as f:
                data.extend(json.load(f))
        return data
    if isinstance(label, list):
        return label
    with open(label) as f:
        return json.load(f)


class AudioPhraseEvalDataset(Dataset):
    """One item per (audio, phrase) pair.  ``waveform``: the index TSV, or
    a dict of waveforms in memory by audio id."""

    def __init__(self, waveform, label, sample_rate: int = 32000):
        self.aid_to_h5 = (waveform if isinstance(waveform, dict)
                          else load_dict_from_csv(waveform,
                                                  ("audio_id", "hdf5_path")))
        self.cache: dict = {}
        self.data = _load_label(label)
        self.sample_rate = sample_rate
        self.generate_index()

    def generate_index(self) -> None:
        """(audio, phrase) index pairs over ``self.data``; call again after
        replacing it."""
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
        source = self.aid_to_h5[audio_item["audio_id"]]
        waveform = (source if isinstance(source, np.ndarray) else
                    read_from_h5(audio_item["audio_id"], source, self.cache))
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


class AudioSamplePhrasesDataset(AudioReadMixin, Dataset):
    """WSTAG items: a clip, its caption's phrases (label 1) and sampled
    negative phrases (label 0) up to ``phrase_num``.

    Negative sampling (``neg_samp_stratg``), each drawing from
    ``self.rng``, a ``numpy.random.default_rng`` of ``seed``, in the JAX
    class's order of calls, so that the same seed and ``reseed`` salt give
    the same items:

    * ``random``: uniform over the phrases that are not positives;
    * ``similarity``: a shuffled scan in chunks of the needed count,
      keeping candidates whose largest cosine similarity to a positive
      (``phrase_embed``: a ``.pkl`` dict or an ``.h5`` file) is below
      ``sim_threshold``, over the caption phrases or a ``negative_pool``
      file;
    * ``clustering``: phrases from clusters (``cluster_map`` JSON) that hold
      no positive, with several passes when there are fewer such clusters
      than negatives needed, and uniform sampling when every cluster holds
      a positive.

    ``fix_neg`` keeps each clip's first negatives, ``max_phrase_length``
    drops longer phrases, ``max_audio_length`` (seconds) crops a random
    window.
    """

    def __init__(self, audio: str, label, phrase_num: int, fix_neg: bool,
                 neg_samp_stratg: str = "clustering",
                 max_phrase_length: Optional[int] = None,
                 sample_rate: int = 32000,
                 max_audio_length: Optional[float] = None,
                 seed: int = 0, **kwargs):
        AudioReadMixin.__init__(self, sample_rate)
        self.aid_to_fpath = load_dict_from_csv(audio,
                                               ("audio_id", "file_path"))
        self.max_audio_len = (int(max_audio_length * sample_rate)
                              if max_audio_length is not None else None)
        self.max_phrase_len = max_phrase_length
        self.data = _load_label(label)
        self.phrase_num = phrase_num
        self.rng = np.random.default_rng(seed)
        self._seed = seed
        if neg_samp_stratg not in ("random", "clustering", "similarity"):
            raise ValueError(f"bad neg_samp_stratg {neg_samp_stratg}")

        phrases = []
        kept_data = []
        for audio_item in self.data:
            kept = False
            for phrase in audio_item["phrases"]:
                if self._too_long(phrase):
                    continue
                phrases.append(phrase)
                kept = True
            if kept:
                kept_data.append(audio_item)
        self.data = kept_data
        self._set_phrases(np.array(sorted(set(phrases))))

        self.fix_neg = fix_neg
        self.aid_to_neg: dict = {}
        self.neg_samp_stratg = neg_samp_stratg
        if neg_samp_stratg == "clustering":
            if "cluster_map" not in kwargs:
                raise ValueError("cluster_map not provided")
            (self.cluster_idx_to_phrases,
             self.phrase_to_cluster_idx) = self.read_cluster_map(
                kwargs["cluster_map"])
            self.cluster_idxs = np.array(
                list(self.cluster_idx_to_phrases.keys()))
            self.cluster_idx_to_idx = {c: i for i, c in
                                       enumerate(self.cluster_idxs)}
        elif neg_samp_stratg == "similarity":
            if "phrase_embed" not in kwargs or "sim_threshold" not in kwargs:
                raise ValueError("phrase_embed / sim_threshold not provided")
            self.sim_threshold = kwargs["sim_threshold"]
            phrase_to_emb = self._read_embeddings(kwargs["phrase_embed"])
            if "negative_pool" in kwargs:
                with open(kwargs["negative_pool"]) as reader:
                    pool = [line.strip() for line in reader]
                self._set_phrases(np.array(
                    [p for p in pool if not self._too_long(p)]))
            embs = np.stack([phrase_to_emb[p] for p in self.phrases])
            norms = np.linalg.norm(embs, axis=-1, keepdims=True)
            self._unit_embs = embs / np.maximum(norms, 1e-12)

    def _too_long(self, phrase: str) -> bool:
        return (self.max_phrase_len is not None
                and len(phrase.split()) > self.max_phrase_len)

    def _set_phrases(self, phrases: np.ndarray) -> None:
        self.phrases = phrases
        self.phrase_to_idx = {p: i for i, p in enumerate(phrases)}

    def _read_embeddings(self, path: str) -> dict:
        """Phrase → embedding, from a pickled dict or an HDF5 file keyed by
        phrase (``/`` written ``%2F``)."""
        if path.endswith(".pkl"):
            with open(path, "rb") as f:
                return pickle.load(f)
        import h5py
        with h5py.File(path, "r") as hf:
            return {p: hf[p.replace("/", "%2F")][()] for p in self.phrases}

    def reseed(self, salt: int) -> None:
        """``rng`` anew from the construction seed + ``salt`` (the epoch,
        or a batch's salt in loader workers)."""
        self.rng = np.random.default_rng(self._seed + salt)

    def __getstate__(self):
        # open h5py handles do not pickle; worker processes reopen them
        state = dict(self.__dict__)
        if isinstance(state.get("h5_cache"), dict):
            state["h5_cache"] = {}
        return state

    def read_cluster_map(self, cluster_map: str) -> tuple:
        with open(cluster_map) as f:
            mapping = json.load(f)
        phrase_to_cluster_idx = {}
        cluster_idx_to_phrases = {}
        phrase_set = set(self.phrases.tolist())
        for cluster_idx, phrases in mapping.items():
            cluster_idx = int(cluster_idx)
            filtered = []
            for phrase in phrases:
                phrase_to_cluster_idx[phrase] = cluster_idx
                if phrase in phrase_set and not self._too_long(phrase):
                    filtered.append(phrase)
            cluster_idx_to_phrases[cluster_idx] = filtered
        return cluster_idx_to_phrases, phrase_to_cluster_idx

    def _similarity_negatives(self, pos_idxs: list, cand_idxs: np.ndarray,
                              count: int) -> list:
        pos_embs = self._unit_embs[pos_idxs]
        neg_sel: list[int] = []
        self.rng.shuffle(cand_idxs)
        pointer = 0
        while len(neg_sel) < count and pointer < len(cand_idxs):
            left = count - len(neg_sel)
            part = cand_idxs[pointer:pointer + count]
            sims = (pos_embs @ self._unit_embs[part].T).max(axis=0)
            ok = np.where(sims < self.sim_threshold)[0]
            neg_sel.extend(part[ok[:left]].tolist())
            pointer += count
        while neg_sel and len(neg_sel) < count:
            neg_sel.extend(neg_sel[:count - len(neg_sel)])
        return [self.phrases[i] for i in neg_sel]

    def _cluster_negatives(self, pos_phrases: list, cand_phrases: np.ndarray,
                           count: int) -> list:
        neg_phrases = []
        pos_clusters = sorted({self.phrase_to_cluster_idx[p]
                               for p in pos_phrases
                               if p in self.phrase_to_cluster_idx})
        cand_clusters = np.delete(
            self.cluster_idxs,
            [self.cluster_idx_to_idx[c] for c in pos_clusters
             if c in self.cluster_idx_to_idx])
        if len(cand_clusters) == 0:
            # every cluster holds a positive: uniform over the phrases that
            # are not positives
            return list(self.rng.choice(
                cand_phrases, size=min(count, len(cand_phrases)),
                replace=False))
        if len(cand_clusters) >= count:
            for c in self.rng.choice(cand_clusters, size=count,
                                     replace=False):
                pool = self.cluster_idx_to_phrases[c]
                if pool:
                    neg_phrases.append(str(self.rng.choice(pool)))
            return neg_phrases
        samp_num = np.zeros(len(cand_clusters), dtype=int)
        remaining = count
        while remaining > len(cand_clusters):
            samp_num += 1
            remaining -= len(cand_clusters)
        if remaining > 0:
            samp_num[self.rng.choice(len(cand_clusters), size=remaining,
                                     replace=False)] += 1
        for idx, num in enumerate(samp_num):
            pool = self.cluster_idx_to_phrases[cand_clusters[idx]]
            if pool and num:
                take = self.rng.choice(pool, size=min(num, len(pool)),
                                       replace=False)
                neg_phrases.extend(str(p) for p in take)
        return neg_phrases

    def sample_negative_phrases(self, pos_phrases: list,
                                audio_id: str) -> list:
        count = max(0, self.phrase_num - len(pos_phrases))
        if self.fix_neg and audio_id in self.aid_to_neg:
            neg_idxs = list(self.aid_to_neg[audio_id])
            while len(neg_idxs) < count:
                neg_idxs.extend(neg_idxs)
            return [self.phrases[i] for i in neg_idxs[:count]]

        pos_idxs = [self.phrase_to_idx[p] for p in pos_phrases
                    if p in self.phrase_to_idx]
        cand_phrases = np.delete(self.phrases, pos_idxs)
        if self.neg_samp_stratg == "random":
            neg_phrases = list(self.rng.choice(cand_phrases, size=count,
                                               replace=False))
        elif self.neg_samp_stratg == "similarity":
            neg_phrases = self._similarity_negatives(
                pos_idxs, np.delete(np.arange(len(self.phrases)), pos_idxs),
                count)
        else:
            neg_phrases = self._cluster_negatives(pos_phrases, cand_phrases,
                                                  count)
        while len(neg_phrases) < count and neg_phrases:
            neg_phrases.append(neg_phrases[-1])
        if self.fix_neg:
            self.aid_to_neg[audio_id] = [self.phrase_to_idx[p]
                                         for p in neg_phrases]
        return neg_phrases

    def __getitem__(self, index):
        audio_item = self.data[index]
        audio_id = audio_item["audio_id"]
        waveform = self.load_audio(audio_id, self.aid_to_fpath[audio_id])
        if (self.max_audio_len is not None
                and waveform.shape[0] > self.max_audio_len):
            start = int(self.rng.integers(
                0, waveform.shape[0] - self.max_audio_len + 1))
            waveform = waveform[start:start + self.max_audio_len]
        pos_phrases = [p for p in audio_item["phrases"][:self.phrase_num]
                       if not self._too_long(p)]
        neg_phrases = list(self.sample_negative_phrases(pos_phrases,
                                                        audio_id))
        label = np.array([1.0] * len(pos_phrases) + [0.0] * len(neg_phrases),
                         dtype=np.float32)
        return {"waveform": waveform, "phrases": pos_phrases + neg_phrases,
                "label": label}

    def __len__(self):
        return len(self.data)


class SamplePhrasesCountDataset(AudioSamplePhrasesDataset):
    """Adds ``counts``, each phrase's count in the ``phrase_count`` JSON
    (0 where it has none), for the frequency-weighted losses."""

    def __init__(self, *args, **kwargs):
        phrase_count = kwargs.pop("phrase_count")
        super().__init__(*args, **kwargs)
        with open(phrase_count) as f:
            self.phrase_to_count = json.load(f)

    def __getitem__(self, index):
        output = super().__getitem__(index)
        output["counts"] = np.array(
            [self.phrase_to_count.get(p, 0) for p in output["phrases"]],
            dtype=np.float32)
        return output


class _CaptionAudio(AudioReadMixin, Dataset):
    """The caption datasets' waveforms: ``waveform`` is the index TSV
    (``audio_id<TAB>hdf5_path``, an HDF5 store or a WAV file) or a dict of
    waveforms in memory by audio id."""

    def __init__(self, waveform, label, sample_rate: int = 32000):
        AudioReadMixin.__init__(self, sample_rate)
        self.aid_to_h5 = (waveform if isinstance(waveform, dict)
                          else load_dict_from_csv(waveform,
                                                  ("audio_id", "hdf5_path")))
        self.data = _load_label(label)

    def read(self, audio_id: str) -> np.ndarray:
        source = self.aid_to_h5[audio_id]
        if isinstance(source, np.ndarray):
            return as_wire(source)
        return self.load_audio(audio_id, source)


class _PhraseItems(_CaptionAudio):
    """One item per (audio, phrase) of the grounding label JSON: the
    phrase (a list of one, under ``phrase_key``) and its token indices."""

    phrase_key = "phrases"

    def __init__(self, waveform, label, sample_rate: int = 32000):
        super().__init__(waveform, label, sample_rate)
        self.idxs = [(ai, pi) for ai, item in enumerate(self.data)
                     for pi, _ in enumerate(item["phrases"])]

    def __getitem__(self, index):
        audio_idx, phrase_idx = self.idxs[index]
        item = self.data[audio_idx]
        phrase_item = item["phrases"][phrase_idx]
        return {"audiocap_id": item["audiocap_id"],
                "waveform": self.read(item["audio_id"]),
                self.phrase_key: [phrase_item["phrase"]],
                "start_index": phrase_item["start_index"],
                "end_index": phrase_item["end_index"]}

    def __len__(self):
        return len(self.idxs)


class AudioCaptionPhrasesEvalDataset(_PhraseItems):
    """Per-phrase evaluation items, the phrase under ``phrases``
    (``max_phrase_words`` is taken and unused, as in the JAX class)."""

    def __init__(self, waveform, label, max_phrase_words: int = 10):
        super().__init__(waveform, label)


class SinglePhraseEvalDataset(_PhraseItems):
    """Per-phrase evaluation items, the phrase under ``phrase``."""

    phrase_key = "phrase"


class AudioCaptionPhrasesDataset(_CaptionAudio):
    """Every phrase of a caption of at most ``max_phrase_words`` words (the
    captions with none are dropped): ``{audiocap_id, waveform,
    phrases}``."""

    def __init__(self, waveform, label, max_phrase_words: int = 10):
        super().__init__(waveform, label)
        self.max_phrase_words = max_phrase_words
        self.data = [item for item in self.data
                     if any(self._short(p) for p in item["phrases"])]

    def _short(self, phrase_item: dict) -> bool:
        return len(phrase_item["phrase"].split()) <= self.max_phrase_words

    def __getitem__(self, index):
        item = self.data[index]
        return {"audiocap_id": item["audiocap_id"],
                "waveform": self.read(item["audio_id"]),
                "phrases": [p["phrase"] for p in item["phrases"]
                            if self._short(p)]}

    def __len__(self):
        return len(self.data)


class AudioCaptionDataset(_CaptionAudio):
    """A clip and its tokenized caption (``tokens``, cut to
    ``max_cap_length``): ``{audiocap_id, waveform, caption}``.  A clip
    longer than ``max_audio_length`` seconds is cropped at a start drawn
    from ``self.rng`` (``numpy.random.default_rng(seed)``, anew from
    ``seed + salt`` by ``reseed``), as in the JAX class."""

    def __init__(self, waveform, label,
                 max_audio_length: Optional[float] = None,
                 max_cap_length: Optional[int] = None,
                 sample_rate: int = 32000, seed: int = 0):
        super().__init__(waveform, label, sample_rate)
        self.max_audio_len = (int(max_audio_length * sample_rate)
                              if max_audio_length is not None else None)
        self.max_cap_length = max_cap_length
        self.rng = np.random.default_rng(seed)
        self._seed = seed

    def reseed(self, salt: int) -> None:
        self.rng = np.random.default_rng(self._seed + salt)

    def __getitem__(self, index):
        item = self.data[index]
        waveform = self.read(item["audio_id"])
        if (self.max_audio_len is not None
                and waveform.shape[0] > self.max_audio_len):
            start = int(self.rng.integers(
                0, waveform.shape[0] - self.max_audio_len + 1))
            waveform = waveform[start:start + self.max_audio_len]
        caption = item["tokens"]
        if self.max_cap_length is not None:
            caption = caption[:self.max_cap_length]
        return {"audiocap_id": item["audiocap_id"], "waveform": waveform,
                "caption": caption}

    def __len__(self):
        return len(self.data)


class AudioCaptionPhraseIndicesDataset(AudioCaptionDataset):
    """Adds each phrase's ``start_indices`` / ``end_indices`` (token
    positions in the caption)."""

    def __getitem__(self, index):
        output = super().__getitem__(index)
        phrases = self.data[index]["phrases"]
        output["start_indices"] = [p["start_index"] for p in phrases]
        output["end_indices"] = [p["end_index"] for p in phrases]
        return output
