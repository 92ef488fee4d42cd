"""Host-side IO: the waveform index TSV, HDF5 waveform stores and WAV
files.

Copies of ``texttoaudiogrounding_tpu/data/h5io.py``'s ``as_wire``,
``load_dict_from_csv`` (here with the standard ``csv`` module),
``read_from_h5`` (``h5py`` imported only when an HDF5 file is read),
``resample_poly``, ``load_wav`` (``scipy`` imported only when a WAV file
is read) and ``AudioReadMixin``.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np


def as_wire(waveform) -> np.ndarray:
    """float16-packed waveforms stay float16 through collate and the copy
    to the card (the trainer upcasts there); anything else becomes f32."""
    arr = np.asarray(waveform)
    if arr.dtype == np.float16:
        return arr
    return arr.astype(np.float32, copy=False)


def load_dict_from_csv(path: str, cols: tuple) -> dict:
    """Two columns of a tab-separated file with a header → dict."""
    with open(path, newline="") as f:
        return {row[cols[0]]: row[cols[1]]
                for row in csv.DictReader(f, delimiter="\t")}


def read_from_h5(key: str, hdf5_path: str,
                 cache: Optional[Dict] = None) -> np.ndarray:
    """One dataset of an HDF5 file, with an optional open-handle cache."""
    import h5py

    if cache is None:
        with h5py.File(hdf5_path, "r") as hf:
            return hf[key][()]
    if hdf5_path not in cache:
        cache[hdf5_path] = h5py.File(hdf5_path, "r")
    return cache[hdf5_path][key][()]


def resample_poly(waveform: np.ndarray, orig_sr: int,
                  target_sr: int) -> np.ndarray:
    """Polyphase resampling."""
    if orig_sr == target_sr:
        return waveform
    from math import gcd

    from scipy.signal import resample_poly as _rp
    g = gcd(orig_sr, target_sr)
    return _rp(waveform, target_sr // g, orig_sr // g).astype(waveform.dtype)


def load_wav(file_path: str, target_sr: int) -> np.ndarray:
    """An uncompressed WAV file as mono f32 at ``target_sr``."""
    from scipy.io import wavfile
    orig_sr, data = wavfile.read(file_path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return resample_poly(data, orig_sr, target_sr)


class AudioReadMixin:
    """Waveforms from an HDF5 store (by audio id) or from a WAV file."""

    def __init__(self, sample_rate: int, use_cache: bool = False):
        self.h5_cache: Optional[Dict] = {} if use_cache else None
        self.sample_rate = sample_rate

    def load_audio(self, audio_id: str, file_path: str) -> np.ndarray:
        if file_path.endswith((".hdf5", ".h5")):
            waveform = read_from_h5(audio_id, file_path, self.h5_cache)
        else:
            waveform = load_wav(file_path, self.sample_rate)
        return as_wire(waveform)
