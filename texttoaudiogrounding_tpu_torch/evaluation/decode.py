"""Frame-probability decoding: scores → (onset, offset) frame segments.

Copies of ``median_filter`` and ``find_contiguous_regions`` from
``texttoaudiogrounding_tpu/evaluation/decode.py`` (reference
utils/eval_util.py:18-63).
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
