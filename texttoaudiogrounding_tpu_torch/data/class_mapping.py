"""Class-mapping datasets: phrases → AudioSet classes or cluster ids.

Port of ``texttoaudiogrounding_tpu/data/class_mapping.py:41-489``
(reference datasets/class_mapping_dataset.py:15-569) over the same files:
the waveform index TSV and HDF5 stores, the grounding label JSON
(``datasets._load_label``), phrase and class-label embedding pickles, a
pickled scikit-learn ``LabelEncoder``, a ``joblib`` dump of a
scikit-learn ``KMeans`` (``joblib`` imported in the k-means constructors
only, as in the JAX package) and a cluster-map JSON.  Items are the JAX
ones key for key and dtype for dtype (waveforms f32); a random crop
draws from the dataset's seeded numpy generator, which ``reseed(salt)``
makes anew from the construction seed + ``salt`` (the loader's epoch or
batch salt, ``data/loader.py``).  They are ``torch.utils.data.Dataset``s
of numpy items.
"""

from __future__ import annotations

import json
import math
import pickle
from typing import List, Optional

import numpy as np
from torch.utils.data import Dataset

from texttoaudiogrounding_tpu_torch.data.datasets import _load_label
from texttoaudiogrounding_tpu_torch.data.h5io import (
    load_dict_from_csv,
    read_from_h5,
)


class _H5Items(Dataset):
    """Open HDF5 handles do not pickle: worker processes reopen them."""

    def __getstate__(self):
        state = dict(self.__dict__)
        if isinstance(state.get("cache"), dict):
            state["cache"] = {}
        return state


class _Cropped(_H5Items):
    """A dataset with a seeded crop generator."""

    def reseed(self, salt: int) -> None:
        self.rng = np.random.default_rng(self._seed + salt)


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return a @ b.T


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


class _EmbeddingMapMixin:
    def _load_embeddings(self, phrase_embed: str, as_label_embed: str):
        self.phrase_to_emb = _load_pickle(phrase_embed)
        self.label_to_emb = _load_pickle(as_label_embed)
        self.label_embs = np.stack(list(self.label_to_emb.values()))


class ASMappingEvalDataset(_EmbeddingMapMixin, _H5Items):
    """Eval items with ``text_idx`` = argmax cosine-similar AudioSet class
    (reference :15-65)."""

    def __init__(self, waveform: str, label: str, phrase_embed: str,
                 as_label_embed: str):
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        self._load_embeddings(phrase_embed, as_label_embed)
        self.idxs = [(ai, pi) for ai, item in enumerate(self.data)
                     for pi, _ in enumerate(item["phrases"])]

    def __getitem__(self, index):
        audio_idx, phrase_idx = self.idxs[index]
        item = self.data[audio_idx]
        phrase_item = item["phrases"][phrase_idx]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        emb = self.phrase_to_emb[phrase_item["phrase"]]
        sim = _cosine(emb.reshape(1, -1), self.label_embs)[0]
        return {
            "audio_id": item["audio_id"],
            "audiocap_id": item["audiocap_id"],
            "start_index": phrase_item["start_index"],
            "end_index": phrase_item["end_index"],
            "waveform": np.asarray(waveform, np.float32),
            "text": item["tokens"],
            "text_idx": int(sim.argmax()),
        }

    def __len__(self):
        return len(self.idxs)


class ASMappingWeakDataset(_EmbeddingMapMixin, _Cropped):
    """Weak one-hot labels from phrase→class similarity (+ AudioSet tags).

    Reference: :68-173 (threshold window / percentile / top-k selection).
    """

    def __init__(self, waveform: str, label: str, audioset_label: str,
                 phrase_embed: str, as_label_embed: str, label_encoder: str,
                 thresholds: Optional[List] = (0.5, 1.0),
                 min_sim_percent: Optional[float] = None,
                 use_audioset_label: bool = True, topk: int = 1,
                 max_phrase_words: int = 10,
                 max_audio_length: Optional[float] = None,
                 sample_rate: int = 32000, seed: int = 0):
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        self._load_embeddings(phrase_embed, as_label_embed)
        self.thresholds = list(thresholds) if thresholds else None
        self.min_sim_percent = min_sim_percent
        self.topk = topk
        self.max_phrase_words = max_phrase_words
        self.label_encoder = _load_pickle(label_encoder)
        self.classes_num = len(self.label_encoder.classes_)
        self.label_to_idx = {lbl: idx for idx, lbl in
                             enumerate(self.label_encoder.classes_)}
        self.aid_to_aslabel = load_dict_from_csv(
            audioset_label, ("audio_id", "event_labels"))
        self.use_audioset_label = use_audioset_label
        self.max_audio_len = (int(max_audio_length * sample_rate)
                              if max_audio_length is not None else None)
        self.sample_rate = sample_rate
        self.rng = np.random.default_rng(seed)
        self._seed = seed
        if min_sim_percent is not None:
            if self.thresholds is not None:
                raise ValueError(
                    "either 'thresholds' or 'min_sim_percent' can be set")
            if topk != 1:
                raise ValueError("topk must be 1 with min_sim_percent")
            self._calc_thresholds()

    def _calc_thresholds(self):
        phrase_embs = np.stack(list(self.phrase_to_emb.values()))
        sims = _cosine(phrase_embs, self.label_embs).max(1)
        self.thresholds = [float(np.percentile(sims,
                                               self.min_sim_percent)), 1.0]

    def assign_phrase_label(self, phrase_emb, label_onehot):
        sim = _cosine(phrase_emb.reshape(1, -1), self.label_embs)[0]
        if sim.max() < self.thresholds[0] or sim.min() > self.thresholds[1]:
            return
        sim[(sim < self.thresholds[0]) | (sim > self.thresholds[1])] = 0
        if self.topk > 0:
            indices = np.argsort(sim)[::-1][:self.topk]
        else:
            indices = np.where(sim)[0]
        label_onehot[indices] = 1

    def __getitem__(self, index):
        item = self.data[index]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        waveform = np.asarray(waveform, np.float32)
        if (self.max_audio_len is not None
                and waveform.shape[0] > self.max_audio_len):
            start = int(self.rng.integers(
                0, waveform.shape[0] - self.max_audio_len + 1))
            waveform = waveform[start:start + self.max_audio_len]
        label = np.zeros(self.classes_num, np.float32)
        for phrase_item in item["phrases"]:
            if len(phrase_item["phrase"].split()) <= self.max_phrase_words:
                self.assign_phrase_label(
                    self.phrase_to_emb[phrase_item["phrase"]], label)
        if self.use_audioset_label:
            for as_label in self.aid_to_aslabel[item["audio_id"]].split(";"):
                label[self.label_to_idx[as_label]] = 1
        return {
            "audiocap_id": item["audiocap_id"],
            "audio_id": item["audio_id"],
            "text": item["tokens"],
            "waveform": waveform,
            "label": label,
        }

    def __len__(self):
        return len(self.data)


class ASMappingEvalLabelSimDataset(_EmbeddingMapMixin, _H5Items):
    """Eval items carrying the full phrase→class similarity vector
    (reference :176-216)."""

    def __init__(self, waveform: str, label: str, phrase_embed: str,
                 as_label_embed: str):
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        self._load_embeddings(phrase_embed, as_label_embed)
        self.idxs = [(ai, pi) for ai, item in enumerate(self.data)
                     for pi, _ in enumerate(item["phrases"])]

    def __getitem__(self, index):
        audio_idx, phrase_idx = self.idxs[index]
        item = self.data[audio_idx]
        phrase_item = item["phrases"][phrase_idx]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        emb = self.phrase_to_emb[phrase_item["phrase"]]
        return {
            "audiocap_id": item["audiocap_id"],
            "start_index": phrase_item["start_index"],
            "end_index": phrase_item["end_index"],
            "waveform": np.asarray(waveform, np.float32),
            "label_sim": _cosine(emb.reshape(1, -1), self.label_embs)[0],
        }

    def __len__(self):
        return len(self.idxs)


class ASMappingStrongDataset(ASMappingWeakDataset):
    """Strong ``[T, C]`` labels + class mask via phrase→class mapping
    (reference :219-293)."""

    def __init__(self, *args, time_resolution: float = 0.02, **kwargs):
        kwargs.setdefault("min_sim_percent", None)
        super().__init__(*args, **kwargs)
        self.time_resolution = time_resolution

    def _assign_strong(self, phrase_item, weak_label, strong_label,
                       strong_label_mask):
        emb = self.phrase_to_emb[phrase_item["phrase"]]
        sim = _cosine(emb.reshape(1, -1), self.label_embs)[0]
        sim[(sim < self.thresholds[0]) | (sim > self.thresholds[1])] = 0
        if self.topk > 0:
            indices = np.argsort(sim)[::-1][:self.topk]
        else:
            indices = np.where(sim)[0]
        weak_label[indices] = 1
        strong_label_mask[indices] = 1
        for start, end in phrase_item["segments"]:
            onset = round(start / self.time_resolution)
            offset = round(end / self.time_resolution)
            strong_label[onset:offset, indices] = 1

    def __getitem__(self, index):
        item = self.data[index]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        waveform = np.asarray(waveform, np.float32)
        n_frame = math.floor(waveform.shape[0] / self.sample_rate
                             / self.time_resolution) + 1
        weak_label = np.zeros(self.classes_num, np.float32)
        strong_label = np.zeros((n_frame, self.classes_num), np.float32)
        strong_label_mask = np.zeros(self.classes_num, np.float32)
        for phrase_item in item["phrases"]:
            if len(phrase_item["phrase"].split()) <= self.max_phrase_words:
                self._assign_strong(phrase_item, weak_label, strong_label,
                                    strong_label_mask)
        if self.use_audioset_label:
            for as_label in self.aid_to_aslabel[item["audio_id"]].split(";"):
                weak_label[self.label_to_idx[as_label]] = 1
        return {
            "audiocap_id": item["audiocap_id"],
            "audio_id": item["audio_id"],
            "text": item["tokens"],
            "waveform": waveform,
            "weak_label": weak_label,
            "strong_label": strong_label,
            "strong_label_mask": strong_label_mask,
        }


class _KmeansMixin:
    def _prepare_phrase_label(self, max_dist_percent: Optional[float] = None):
        phrases = sorted({p["phrase"] for item in self.data
                          for p in item["phrases"]})
        embs = np.stack([self.phrase_to_emb[p] for p in phrases])
        labels = self.cluster_model.predict(embs)
        self.phrase_to_label = dict(zip(phrases, labels))
        if max_dist_percent is not None:
            distances = self.cluster_model.transform(embs).min(axis=1)
            self.max_distance = float(np.percentile(distances,
                                                    max_dist_percent))
            self.phrase_to_distance = dict(zip(phrases, distances))


class KmeansMappingEvalDataset(_KmeansMixin, _H5Items):
    """Eval items with ``text_idx`` = k-means cluster of the phrase
    (reference :296-353)."""

    def __init__(self, waveform: str, label: str, phrase_embed: str,
                 cluster_model: str):
        import joblib
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        self.cluster_model = joblib.load(cluster_model)
        self.classes_num = self.cluster_model.n_clusters
        self.phrase_to_emb = _load_pickle(phrase_embed)
        self._prepare_phrase_label()
        self.idxs = [(ai, pi) for ai, item in enumerate(self.data)
                     for pi, _ in enumerate(item["phrases"])]

    def __getitem__(self, index):
        audio_idx, phrase_idx = self.idxs[index]
        item = self.data[audio_idx]
        phrase_item = item["phrases"][phrase_idx]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        return {
            "audiocap_id": item["audiocap_id"],
            "audio_id": item["audio_id"],
            "text": item["tokens"],
            "waveform": np.asarray(waveform, np.float32),
            "text_idx": int(self.phrase_to_label[phrase_item["phrase"]]),
            "start_index": phrase_item["start_index"],
            "end_index": phrase_item["end_index"],
        }

    def __len__(self):
        return len(self.idxs)


class KmeansMappingDataset(_KmeansMixin, _Cropped):
    """Weak/strong labels from k-means cluster ids, with an outlier distance
    percentile filter (reference :356-449)."""

    def __init__(self, waveform: str, label: str, phrase_embed: str,
                 cluster_model: str, label_type: str = "weak",
                 max_dist_percent: float = 95.0,
                 time_resolution: float = 0.02, sample_rate: int = 32000,
                 max_audio_length: Optional[float] = None,
                 no_waveform: bool = False, seed: int = 0):
        import joblib
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        self.label_type = label_type
        self.cluster_model = joblib.load(cluster_model)
        self.classes_num = self.cluster_model.n_clusters
        self.phrase_to_emb = _load_pickle(phrase_embed)
        self._prepare_phrase_label(max_dist_percent)
        self.time_resolution = time_resolution
        self.sample_rate = sample_rate
        self.no_waveform = no_waveform
        self.max_audio_len = (int(max_audio_length * sample_rate)
                              if max_audio_length is not None else None)
        self.rng = np.random.default_rng(seed)
        self._seed = seed

    def __getitem__(self, index):
        item = self.data[index]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        waveform = np.asarray(waveform, np.float32)
        if (self.max_audio_len is not None
                and waveform.shape[0] > self.max_audio_len):
            start = int(self.rng.integers(
                0, waveform.shape[0] - self.max_audio_len + 1))
            waveform = waveform[start:start + self.max_audio_len]
        output = {
            "audiocap_id": item["audiocap_id"],
            "audio_id": item["audio_id"],
            "text": item["tokens"],
        }
        if not self.no_waveform:
            output["waveform"] = waveform
        if self.label_type == "weak":
            label = np.zeros(self.classes_num, np.float32)
            for phrase_item in item["phrases"]:
                phrase = phrase_item["phrase"]
                if self.phrase_to_distance[phrase] <= self.max_distance:
                    label[self.phrase_to_label[phrase]] = 1
            output["label"] = label
        elif self.label_type == "strong":
            n_frame = math.floor(waveform.shape[0] / self.sample_rate
                                 / self.time_resolution) + 1
            weak_label = np.zeros(self.classes_num, np.float32)
            strong_label = np.zeros((n_frame, self.classes_num), np.float32)
            for phrase_item in item["phrases"]:
                phrase = phrase_item["phrase"]
                if self.phrase_to_distance[phrase] <= self.max_distance:
                    label_idx = self.phrase_to_label[phrase]
                    weak_label[label_idx] = 1
                    for start, end in phrase_item["segments"]:
                        onset = round(start / self.time_resolution)
                        offset = round(end / self.time_resolution)
                        strong_label[onset:offset, label_idx] = 1
            output["weak_label"] = weak_label
            output["strong_label"] = strong_label
        return output

    def __len__(self):
        return len(self.data)


class SpectralMappingEvalDataset(_H5Items):
    """Eval items with ``text_idx`` from a cluster-map JSON
    (reference :452-495)."""

    def __init__(self, waveform: str, label: str, cluster_map: str):
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        with open(cluster_map) as f:
            self.cluster_map = json.load(f)
        self.phrase_to_idx = {phrase: int(idx)
                              for idx, phrases in self.cluster_map.items()
                              for phrase in phrases}
        self.idxs = [(ai, pi) for ai, item in enumerate(self.data)
                     for pi, _ in enumerate(item["phrases"])]

    def __getitem__(self, index):
        audio_idx, phrase_idx = self.idxs[index]
        item = self.data[audio_idx]
        phrase_item = item["phrases"][phrase_idx]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        return {
            "audiocap_id": item["audiocap_id"],
            "audio_id": item["audio_id"],
            "text": item["tokens"],
            "waveform": np.asarray(waveform, np.float32),
            "text_idx": self.phrase_to_idx[phrase_item["phrase"]],
            "start_index": phrase_item["start_index"],
            "end_index": phrase_item["end_index"],
        }

    def __len__(self):
        return len(self.idxs)


class SpectralMappingDataset(_Cropped):
    """Weak/strong labels from a cluster-map JSON (reference :498-569)."""

    def __init__(self, waveform: str, label: str, cluster_map: str,
                 label_type: str = "weak", time_resolution: float = 0.02,
                 sample_rate: int = 32000,
                 max_audio_length: Optional[float] = None,
                 no_waveform: bool = False, seed: int = 0):
        self.aid_to_h5 = load_dict_from_csv(waveform,
                                            ("audio_id", "hdf5_path"))
        self.cache: dict = {}
        self.data = _load_label(label)
        self.label_type = label_type
        with open(cluster_map) as f:
            self.cluster_map = json.load(f)
        self.phrase_to_idx = {phrase: int(idx)
                              for idx, phrases in self.cluster_map.items()
                              for phrase in phrases}
        self.classes_num = len(self.cluster_map)
        self.time_resolution = time_resolution
        self.sample_rate = sample_rate
        self.no_waveform = no_waveform
        self.max_audio_len = (int(max_audio_length * sample_rate)
                              if max_audio_length is not None else None)
        self.rng = np.random.default_rng(seed)
        self._seed = seed

    def __getitem__(self, index):
        item = self.data[index]
        waveform = read_from_h5(item["audio_id"],
                                self.aid_to_h5[item["audio_id"]], self.cache)
        waveform = np.asarray(waveform, np.float32)
        if (self.max_audio_len is not None
                and waveform.shape[0] > self.max_audio_len):
            start = int(self.rng.integers(
                0, waveform.shape[0] - self.max_audio_len + 1))
            waveform = waveform[start:start + self.max_audio_len]
        output = {
            "audiocap_id": item["audiocap_id"],
            "audio_id": item["audio_id"],
            "text": item["tokens"],
        }
        if not self.no_waveform:
            output["waveform"] = waveform
        if self.label_type == "weak":
            label = np.zeros(self.classes_num, np.float32)
            for phrase_item in item["phrases"]:
                label[self.phrase_to_idx[phrase_item["phrase"]]] = 1
            output["label"] = label
        elif self.label_type == "strong":
            n_frame = math.floor(waveform.shape[0] / self.sample_rate
                                 / self.time_resolution) + 1
            weak_label = np.zeros(self.classes_num, np.float32)
            strong_label = np.zeros((n_frame, self.classes_num), np.float32)
            for phrase_item in item["phrases"]:
                label_idx = self.phrase_to_idx[phrase_item["phrase"]]
                weak_label[label_idx] = 1
                for start, end in phrase_item["segments"]:
                    onset = round(start / self.time_resolution)
                    offset = round(end / self.time_resolution)
                    strong_label[onset:offset, label_idx] = 1
            output["weak_label"] = weak_label
            output["strong_label"] = strong_label
        return output

    def __len__(self):
        return len(self.data)
