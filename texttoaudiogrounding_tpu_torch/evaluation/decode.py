"""Frame-probability decoding: scores → (onset, offset) segments.

Port of ``texttoaudiogrounding_tpu/evaluation/decode.py`` (reference
utils/eval_util.py:18-116, utils/sed_utils.py:145-197): binarize → median
filter → connect clusters (merge gaps ≤ n frames) → contiguous regions →
frames to seconds, and the hysteresis decoder.  ``decode_multi_threshold``
decodes one track at every threshold at once, in the native decoder
(``native/decode.cpp``) or in NumPy; both give the same segments bit for
bit.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage


def find_contiguous_regions(activity_array: np.ndarray) -> np.ndarray:
    """[T] bool → [R, 2] array of (onset, offset) frame indices."""
    activity_array = np.asarray(activity_array).astype(bool)
    change_indices = np.logical_xor(activity_array[1:],
                                    activity_array[:-1]).nonzero()[0] + 1
    if activity_array[0]:
        change_indices = np.r_[0, change_indices]
    if activity_array[-1]:
        change_indices = np.r_[change_indices, activity_array.size]
    return change_indices.reshape((-1, 2))


def binarize(x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Strictly-greater binarization (sklearn ``pre.binarize``)."""
    return (np.asarray(x) > threshold).astype(int)


def median_filter(x: np.ndarray, window_size: int,
                  threshold: float = 0.5) -> np.ndarray:
    """Binarize then median-filter along the time axis (3-D = [B, T, C],
    2-D with one row = [1, T], 2-D = [T, C])."""
    x = binarize(x, threshold=threshold)
    if x.ndim == 3:
        size = (1, window_size, 1)
    elif x.ndim == 2 and x.shape[0] == 1:
        size = (1, window_size)
    elif x.ndim == 2:
        size = (window_size, 1)
    else:
        size = (window_size,)
    return scipy.ndimage.median_filter(x, size=size)


def connect_(pairs, n: int = 1) -> list:
    """Merge adjacent (start, end) clusters whose gap ≤ n."""
    if len(pairs) == 0:
        return []
    start_, end_ = pairs[0]
    new_pairs = []
    for next_item, cur_item in zip(pairs[1:], pairs[:-1]):
        end_ = next_item[1]
        if next_item[0] - cur_item[1] > n:
            new_pairs.append((start_, cur_item[1]))
            start_ = next_item[0]
    new_pairs.append((start_, end_))
    return new_pairs


def _connect_clusters_1d(x: np.ndarray, n: int = 1) -> np.ndarray:
    out = np.zeros_like(x, dtype=int)
    for lo, hi in connect_(find_contiguous_regions(x), n=n):
        out[lo:hi] = 1
    return out


def connect_clusters(x: np.ndarray, n: int = 1) -> np.ndarray:
    """Connect 0/1 clusters closer than ``n`` frames (axis -2 for
    ndim ≥ 2)."""
    x = np.asarray(x)
    if x.ndim == 1:
        return _connect_clusters_1d(x, n)
    return np.apply_along_axis(lambda a: _connect_clusters_1d(a, n), -2, x)


def predictions_to_time(events: dict, ratio: float) -> dict:
    """A table's frame-index ``onset`` / ``offset`` → seconds."""
    if len(events.get("onset", ())) == 0:
        return events
    return {**events, "onset": events["onset"] * ratio,
            "offset": events["offset"] * ratio}


def _double_threshold_1d(x: np.ndarray, high_thres: float, low_thres: float,
                         n_connect: int = 1) -> np.ndarray:
    high_locations = np.where(x > high_thres)[0]
    regions = find_contiguous_regions(x > low_thres)
    kept = [pair for pair in regions
            if ((pair[0] <= high_locations)
                & (high_locations <= pair[1])).any()]
    out = np.zeros_like(x, dtype=int)
    for lo, hi in connect_(kept, n_connect):
        out[lo:hi] = 1
    return out


def double_threshold(x: np.ndarray, high_thres: float, low_thres: float,
                     n_connect: int = 1) -> np.ndarray:
    """Hysteresis decoding: keep low-threshold regions that hold at least
    one high-threshold frame.  x: [T], [T, C] or [B, T, C]; the time axis
    is decoded per track."""
    x = np.asarray(x)
    if x.ndim > 3:
        raise ValueError(f"double_threshold expects <= 3 dims, got {x.ndim}")
    return np.apply_along_axis(
        lambda a: _double_threshold_1d(a, high_thres, low_thres, n_connect),
        axis=1 if x.ndim == 3 else 0, arr=x)


def decode_with_timestamps(classes: list, binary: np.ndarray) -> list:
    """[B, T, C] 0/1 → per-sample lists of (event_label, onset, offset)
    frame indices."""
    results = []
    for sample in binary:
        events = []
        for c, name in enumerate(classes):
            for onset, offset in find_contiguous_regions(
                    sample[:, c].astype(bool)):
                events.append((name, int(onset), int(offset)))
        results.append(events)
    return results


def decode_multi_threshold(scores: np.ndarray, thresholds: np.ndarray,
                           window_size: int, connect_n: int = 1,
                           time_resolution: float = 1.0,
                           use_native: bool = True) -> list[np.ndarray]:
    """One score track ``[T]`` decoded at every threshold ``[K]``: K
    ``[R_k, 2]`` float64 arrays of (onset, offset) seconds.

    binarize(> th) → median filter (per row) → connect clusters (gap ≤
    ``connect_n``) → contiguous regions → × ``time_resolution``, the
    reference's per-threshold loop (run_strong.py:234-252).
    ``use_native`` runs ``native/decode.cpp`` (built on first use; a build
    that fails raises), else NumPy."""
    scores = np.asarray(scores, dtype=np.float32)
    thresholds = np.asarray(thresholds, dtype=np.float32)
    if use_native:
        from texttoaudiogrounding_tpu_torch import native
        return native.decode_multi_threshold(
            scores, thresholds, window_size, connect_n, time_resolution)
    binary = (scores[None, :] > thresholds[:, None]).astype(np.int8)
    filtered = scipy.ndimage.median_filter(binary, size=(1, window_size))
    out = []
    for row in filtered:
        merged = connect_(find_contiguous_regions(row), n=connect_n)
        if len(merged) == 0:
            out.append(np.zeros((0, 2), dtype=np.float64))
        else:
            out.append(np.asarray(merged, dtype=np.float64)
                       * time_resolution)
    return out
