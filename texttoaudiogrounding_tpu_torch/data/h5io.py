"""Host-side IO: the waveform index TSV and HDF5 waveform stores.

Copies of ``texttoaudiogrounding_tpu/data/h5io.py``'s ``as_wire``,
``load_dict_from_csv`` (here with the standard ``csv`` module) and
``read_from_h5`` (``h5py`` imported only when an HDF5 file is read).
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
