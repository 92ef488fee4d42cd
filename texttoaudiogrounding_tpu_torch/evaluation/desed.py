"""Zero-shot sound event detection on DESED with a grounding model.

Port of ``texttoaudiogrounding_tpu/evaluation/desed.py`` (reference
python_scripts/evaluation/evaluate_on_desed.py:124-310), on tables
(``tables.py``) without pandas: each of the 10 DESED classes is named by a
hand-written phrase, and the model scores every clip against every phrase
(:func:`score_clips_zero_shot`: the clip tiled once a class, one phrase a
row, through ``GroundingPredictor.predict``).  The ``[T, 10]`` score
tracks are held to the ground truth by PSDS1 (DTC = GTC = 0.7, alpha_st
1), PSDS2 (DTC = GTC = 0.1, CTTC 0.3, alpha_ct 0.5, alpha_st 1), both
exact and threshold-free up to an eFPR of 100 an hour, and by the
macro-F1 of a double-threshold (0.75 / 0.25) decoding.  Only reading the
waveforms (``run_desed_evaluation``) needs h5py.
"""

from __future__ import annotations

import csv

import numpy as np

from texttoaudiogrounding_tpu_torch.evaluation.decode import (
    binarize,
    decode_with_timestamps,
    double_threshold,
)
from texttoaudiogrounding_tpu_torch.evaluation.psds import (
    PSDSEvaluator,
    compute_psds_sed_scores,
)
from texttoaudiogrounding_tpu_torch.evaluation.tables import table

DESED_CLASSES = [
    "Speech", "Frying", "Dishes", "Running_water", "Blender",
    "Electric_shaver_toothbrush", "Alarm_bell_ringing", "Cat", "Dog",
    "Vacuum_cleaner",
]

# the phrase that names each class (reference evaluate_on_desed.py:124-141)
CLASS_TO_PHRASE = {
    "Speech": "speaking",
    "Frying": "frying",
    "Dishes": "dishes clanking",
    "Running_water": "water",
    "Blender": "machine running",
    "Electric_shaver_toothbrush": "electric shaver",
    "Alarm_bell_ringing": "ringing",
    "Cat": "cat meowing",
    "Dog": "dog barking",
    "Vacuum_cleaner": "vacuum cleaner running",
}

PSDS1_CFG = {"dtc_threshold": 0.7, "gtc_threshold": 0.7,
             "cttc_threshold": 0.0, "alpha_ct": 0.0, "alpha_st": 1.0}
PSDS2_CFG = {"dtc_threshold": 0.1, "gtc_threshold": 0.1,
             "cttc_threshold": 0.3, "alpha_ct": 0.5, "alpha_st": 1.0}


def score_clips_zero_shot(predictor, clips: dict,
                          time_resolution: float = 0.04,
                          classes: list | None = None) -> dict:
    """``clips``: audio id → waveform ``[N]``.  Returns audio id → score
    table (``onset``, ``offset``, one column a class) over the model's
    valid frames (its own length arithmetic), scores clipped to [0, 1].
    ``predictor``: a ``GroundingPredictor``; each clip is one ``predict``
    call of ``len(classes)`` rows, the clip against each class phrase."""
    classes = classes or DESED_CLASSES
    phrases = [CLASS_TO_PHRASE.get(c, c.replace("_", " ").lower())
               for c in classes]
    score_buffer = {}
    for audio_id, waveform in clips.items():
        waveform = np.asarray(waveform, np.float32)
        audio = np.tile(waveform[None], (len(classes), 1))
        lens = np.full((len(classes),), waveform.shape[0])
        probs, out_lens = predictor.predict(audio, lens, phrases,
                                            return_length=True)  # [C, T]
        n = max(int(out_lens[0]), 1)
        scores = np.clip(probs[:, :n].T, 0.0, 1.0)               # [T, C]
        timestamps = np.arange(n + 1) * time_resolution
        score_buffer[audio_id] = table({
            "onset": timestamps[:-1], "offset": timestamps[1:],
            **{cls: scores[:, i] for i, cls in enumerate(classes)}})
    return score_buffer


def evaluate_desed_psds(score_buffer: dict, ground_truth: dict,
                        durations: dict, num_thresholds: int = 50) -> dict:
    """PSDS1 and PSDS2 of the score tracks (reference
    evaluate_on_desed.py:198-214, max_efpr 100).  ``ground_truth``: audio
    id → [(onset, offset, class)]; ``durations``: audio id → seconds."""
    fname_to_aid = {k: k for k in score_buffer}
    return {name: compute_psds_sed_scores(
                scores=score_buffer, ground_truth=ground_truth,
                duration=durations, fname_to_aid=fname_to_aid,
                max_efpr=100.0, num_thresholds=num_thresholds, **cfg)
            for name, cfg in (("psds1", PSDS1_CFG), ("psds2", PSDS2_CFG))}


def evaluate_desed_macro_f1(score_buffer: dict, ground_truth: dict,
                            durations: dict, thresholds=(0.75, 0.25),
                            time_resolution: float = 0.04,
                            classes: list | None = None) -> dict:
    """Operating-point macro-F1 of a double-threshold decoding (one
    threshold: a plain binarization), counted as psds_eval's
    ``compute_macro_f_score`` counts (reference evaluate_on_desed.py:
    217-310): TP the ground truths matched under the GTC, FP the
    detections that fail the DTC, FN the misses, F = 2TP / (2TP + FN +
    FP).  Returns ``macro_f1``, ``class_f1`` and the ``predictions``
    table."""
    classes = classes or DESED_CLASSES
    rows = []
    for audio_id, track in score_buffer.items():
        scores = np.stack([track[c] for c in classes], axis=-1)[None]
        binary = (double_threshold(scores, *thresholds)
                  if len(thresholds) == 2
                  else binarize(scores, threshold=thresholds[0]))
        for event_label, onset, offset in decode_with_timestamps(
                classes, binary)[0]:
            rows.append((audio_id, event_label, onset * time_resolution,
                         offset * time_resolution))
    predictions = table({"filename": [r[0] for r in rows],
                         "event_label": [r[1] for r in rows],
                         "onset": [r[2] for r in rows],
                         "offset": [r[3] for r in rows]})
    events = [(fname, on, off, label)
              for fname, evs in ground_truth.items()
              for on, off, label in evs]
    gt = table({"filename": [e[0] for e in events],
                "onset": [e[1] for e in events],
                "offset": [e[2] for e in events],
                "event_label": [e[3] for e in events]})
    meta = table({"filename": list(durations),
                  "duration": list(durations.values())})
    evaluator = PSDSEvaluator(gt, meta, 0.5, 0.5)
    evaluator.add_operating_point(predictions)
    labels = evaluator.ground_truth["event_label"]
    per_class = {}
    for cls in evaluator.class_names:
        st = evaluator.operating_points[0]["per_class"][cls]
        tp, fp = st["tp"], st["fp"]
        fn = int((labels == cls).sum()) - tp
        per_class[cls] = 2.0 * tp / max(2.0 * tp + fn + fp, 1e-15)
    macro = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return {"macro_f1": macro, "class_f1": per_class,
            "predictions": predictions}


def _read_delimited(path) -> list[dict]:
    """The rows of a tab-separated file with a header, as dicts of
    strings."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def run_desed_evaluation(experiment_path, wav_csv, gt_tsv, duration_tsv,
                         time_resolution: float = 0.04,
                         device="cuda") -> dict:
    """An experiment's directory and the DESED evaluation metadata → the
    metrics: ``wav_csv`` (``audio_id`` and ``hdf5_path`` or ``file_name``),
    ``gt_tsv`` (``filename``, ``onset``, ``offset``, ``event_label``) and
    ``duration_tsv`` (``filename`` or ``audio_id``, ``duration``), all
    tab-separated.  The model runs on ``device`` (the card unless the CPU
    is asked for)."""
    from texttoaudiogrounding_tpu_torch.data.h5io import read_from_h5
    from texttoaudiogrounding_tpu_torch.inference import GroundingPredictor

    predictor = GroundingPredictor.from_experiment(experiment_path,
                                                   device=device)
    wav_rows = _read_delimited(wav_csv)
    durations = {row.get("filename", row.get("audio_id")):
                 float(row["duration"])
                 for row in _read_delimited(duration_tsv)}
    path_col = "hdf5_path" if wav_rows and "hdf5_path" in wav_rows[0] \
        else "file_name"
    cache: dict = {}
    try:
        clips = {row["audio_id"]: read_from_h5(row["audio_id"],
                                               row[path_col], cache)
                 for row in wav_rows}
    finally:
        for handle in cache.values():
            handle.close()
    ground_truth: dict = {aid: [] for aid in clips}
    for row in _read_delimited(gt_tsv):
        if row["event_label"] in DESED_CLASSES and \
                row["filename"] in ground_truth:
            ground_truth[row["filename"]].append(
                (float(row["onset"]), float(row["offset"]),
                 row["event_label"]))
    score_buffer = score_clips_zero_shot(predictor, clips, time_resolution)
    results = evaluate_desed_psds(score_buffer, ground_truth, durations)
    results.update(evaluate_desed_macro_f1(
        score_buffer, ground_truth, durations,
        time_resolution=time_resolution))
    print(f"psds1: {results['psds1']:.4f}, psds2: {results['psds2']:.4f}, "
          f"macro_f1: {results['macro_f1']:.4f}")
    return results
