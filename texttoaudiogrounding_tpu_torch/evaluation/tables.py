"""Event and score tables without pandas.

A table is a dict of equal-length 1-D numpy arrays, one a column, where the
JAX package holds a DataFrame: detections and ground truth
(``filename``, ``event_label``, ``onset``, ``offset`` and perhaps
``audio_id``), score tracks (``onset``, ``offset``, one column a class),
durations (``audio_id``, ``duration``).  ``onset``, ``offset`` and
``duration`` are float64, names are object arrays of ``str``.  TSV files
are read and written with the ``csv`` module.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

FLOAT_COLUMNS = ("onset", "offset", "duration")


def _column(name: str, values) -> np.ndarray:
    if name in FLOAT_COLUMNS:
        return np.asarray(values, np.float64).reshape(-1)
    arr = np.empty(len(values), object)
    arr[:] = list(values)
    return arr


def table(columns: dict) -> dict:
    """Columns as arrays: the float columns as float64, names as objects,
    other numeric arrays as they are."""
    out = {}
    for name, values in columns.items():
        if isinstance(values, np.ndarray) and values.dtype.kind in "fiub" \
                and name not in FLOAT_COLUMNS:
            out[name] = values
        else:
            out[name] = _column(name, values)
    if len({len(v) for v in out.values()}) > 1:
        raise ValueError("table columns differ in length")
    return out


def n_rows(t: dict) -> int:
    return len(next(iter(t.values()))) if t else 0


def select(t: dict, index) -> dict:
    """Rows picked by a boolean mask or an index array."""
    return {name: col[index] for name, col in t.items()}


def drop(t: dict, *names: str) -> dict:
    return {name: col for name, col in t.items() if name not in names}


def read_tsv(path) -> dict:
    """A TSV with a header: ``onset``, ``offset`` and ``duration`` as
    float64, every other column as strings."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    header, body = rows[0], rows[1:]
    return table({name: [r[i] for r in body]
                  for i, name in enumerate(header)})


def _cell(value, float_format: str | None) -> str:
    if isinstance(value, (float, np.floating)):
        return float_format % value if float_format else repr(float(value))
    if isinstance(value, (np.integer, np.bool_)):
        return str(value.item())
    return str(value)


def write_tsv(t: dict, path, float_format: str | None = None) -> None:
    """A table as a TSV with a header (floats by ``repr``, or by
    ``float_format``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(list(t))
        for i in range(n_rows(t)):
            writer.writerow([_cell(col[i], float_format)
                             for col in t.values()])


def read_duration(duration) -> dict:
    """``audio_id`` → seconds, from the duration TSV (``audio_id``,
    ``duration``), from a table with those columns, or from a mapping."""
    if isinstance(duration, (str, Path)):
        duration = read_tsv(duration)
    if "audio_id" in duration and "duration" in duration:
        return dict(zip((str(a) for a in duration["audio_id"]),
                        (float(d) for d in duration["duration"])))
    return {str(k): float(v) for k, v in duration.items()}


def write_curve(path, x_name: str, x, y_name: str, y, *, step: bool = False,
                figsize=(16, 4), ylim=None, savefig_args=None) -> list:
    """A curve's points as ``<path>.tsv`` and, where matplotlib imports,
    its plot as ``<path>.png`` (the JAX package writes the PNG only).
    Returns the files written, and logs them."""
    path = Path(path)
    files = [path.with_name(path.name + ".tsv")]
    write_tsv({x_name: np.asarray(x, np.float64),
               y_name: np.asarray(y, np.float64)}, files[0])
    try:
        import matplotlib
    except ImportError:
        matplotlib = None
    if matplotlib is not None:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure(figsize=figsize)
        if step:
            plt.step(x, y, lw=2, where="post")
        else:
            plt.plot(x, y)
        if ylim is not None:
            plt.ylim(*ylim)
        plt.xlabel(x_name)
        plt.ylabel(y_name)
        files.append(path.with_name(path.name + ".png"))
        plt.savefig(files[-1], **(savefig_args or {}))
        plt.close()
    logging.getLogger(__name__).info(
        "curve written: " + ", ".join(f.name for f in files))
    return files
