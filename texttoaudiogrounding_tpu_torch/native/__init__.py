"""Native (C++) evaluation decoders, built with g++ and loaded with ctypes.

``decode.cpp`` compiles on first use into the port's build directory
(``ops/kernels/_build.build_dir()``, git-ignored), as a library named by a
hash of its source and flags.  The compiler writes to a name of its own
process and the finished library is renamed into place (``os.replace``),
so processes that build at once never load a half-written file.  A call
that cannot build or load the library raises with the compiler's output;
there is no quiet fallback.  The NumPy versions
(``evaluation/decode.py``, ``evaluation/psds.py``) are the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from texttoaudiogrounding_tpu_torch.ops.kernels._build import build_dir

SRC = Path(__file__).with_name("decode.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)
_L = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "decode_multi_threshold": [_F, ctypes.c_int, _F, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_double,
                               _D, ctypes.c_int, _I],
    "file_count_curves": [_F, ctypes.c_int, _D, _D, ctypes.c_int,
                          ctypes.c_double, ctypes.c_double, _F, _L, _L],
    "file_count_curves_ct": [_F, ctypes.c_int, _D, _D, ctypes.c_int, _D, _I,
                             ctypes.c_int, ctypes.c_double, ctypes.c_double,
                             ctypes.c_double, _F, _L, _L, _L],
}


def lib_path() -> Path:
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return build_dir() / f"libttgdecode-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiling it first if it is missing."""
    target = lib_path()
    if target.exists():
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native decoders need it")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def decode_multi_threshold(scores: np.ndarray, thresholds: np.ndarray,
                           window_size: int, connect_n: int,
                           time_resolution: float) -> list[np.ndarray]:
    """K ``[R_k, 2]`` f64 arrays of (onset, offset) seconds."""
    scores = np.ascontiguousarray(scores, np.float32)
    thresholds = np.ascontiguousarray(thresholds, np.float32)
    t, k = len(scores), len(thresholds)
    cap = k * (t // 2 + 2)
    seg_buffer = np.empty(2 * cap, np.float64)
    seg_counts = np.empty(k, np.int32)
    total = library().decode_multi_threshold(
        _ptr(scores, ctypes.c_float), t, _ptr(thresholds, ctypes.c_float),
        k, int(window_size), int(connect_n), float(time_resolution),
        _ptr(seg_buffer, ctypes.c_double), cap,
        _ptr(seg_counts, ctypes.c_int))
    if total < 0:
        raise RuntimeError("decode_multi_threshold: segment buffer overflow")
    pairs = seg_buffer[:2 * total].reshape(-1, 2)
    bounds = np.r_[0, np.cumsum(seg_counts)]
    return [pairs[lo:hi].copy() for lo, hi in zip(bounds[:-1], bounds[1:])]


def _sweep_buffers(score, timestamps, gt_events):
    score = np.ascontiguousarray(score, np.float32)
    timestamps = np.ascontiguousarray(timestamps, np.float64)
    gts = np.ascontiguousarray(
        np.asarray(gt_events, np.float64).reshape(-1, 2))
    t = len(score)
    return (score, timestamps, gts, np.empty(t, np.float32),
            np.empty(t, np.int64), np.empty(t, np.int64))


def file_count_curves(score: np.ndarray, timestamps: np.ndarray,
                      gt_events: list, dtc: float, gtc: float) -> tuple:
    """(unique scores descending, TP counts, FP counts) of one file."""
    score, timestamps, gts, uniques, tps, fps = _sweep_buffers(
        score, timestamps, gt_events)
    nu = library().file_count_curves(
        _ptr(score, ctypes.c_float), len(score),
        _ptr(timestamps, ctypes.c_double), _ptr(gts, ctypes.c_double),
        len(gts), float(dtc), float(gtc), _ptr(uniques, ctypes.c_float),
        _ptr(tps, ctypes.c_int64), _ptr(fps, ctypes.c_int64))
    return uniques[:nu].copy(), tps[:nu].copy(), fps[:nu].copy()


def file_count_curves_ct(score: np.ndarray, timestamps: np.ndarray,
                         gt_events: list, gt_other: dict, dtc: float,
                         gtc: float, cttc: float) -> tuple:
    """As :func:`file_count_curves`, with cross-triggers per other class:
    (uniques, tps, fps, {class: cts})."""
    score, timestamps, gts, uniques, tps, fps = _sweep_buffers(
        score, timestamps, gt_events)
    classes = list(gt_other)
    flat = [np.asarray(gt_other[c], np.float64).reshape(-1, 2)
            for c in classes]
    offsets = np.r_[0, np.cumsum([len(a) for a in flat])].astype(np.int32)
    others = np.ascontiguousarray(
        np.concatenate(flat) if flat else np.zeros((0, 2)), np.float64)
    t = len(score)
    cts = np.empty((max(len(classes), 1), t), np.int64)
    nu = library().file_count_curves_ct(
        _ptr(score, ctypes.c_float), t, _ptr(timestamps, ctypes.c_double),
        _ptr(gts, ctypes.c_double), len(gts), _ptr(others, ctypes.c_double),
        _ptr(offsets, ctypes.c_int), len(classes), float(dtc), float(gtc),
        float(cttc), _ptr(uniques, ctypes.c_float),
        _ptr(tps, ctypes.c_int64), _ptr(fps, ctypes.c_int64),
        _ptr(cts, ctypes.c_int64))
    return (uniques[:nu].copy(), tps[:nu].copy(), fps[:nu].copy(),
            {c: cts[i, :nu].copy() for i, c in enumerate(classes)})
