"""F-score-against-threshold curves: collar-based and intersection-based.

Port of ``texttoaudiogrounding_tpu/evaluation/curves.py`` (reference
run_strong.py:1118-1207): both curves from score tracks on a threshold
grid, with collar matching (sed_eval / sed_scores_eval semantics) or the
DTC / GTC intersection criteria of ``th_auc``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from texttoaudiogrounding_tpu_torch.evaluation.psds import (
    events_at_threshold,
    staircase_auc,
)
from texttoaudiogrounding_tpu_torch.evaluation.th_auc import (
    GroundingPrecisionRecall,
)
from texttoaudiogrounding_tpu_torch.evaluation.tables import table


def collar_fscore_curve(scores: Dict[str, dict],
                        ground_truth: Dict[str, list],
                        onset_collar: float = 0.2,
                        offset_collar: float = 0.2,
                        offset_collar_rate: float = 0.2,
                        num_thresholds: int = 50,
                        event_class: str = "fake_event") -> dict:
    """Collar-based micro F1 over a threshold grid and its staircase AUC:
    onset within ``onset_collar``, offset within ``max(offset_collar,
    offset_collar_rate * gt_length)``."""
    thresholds = np.linspace(0.0, 1.0, num_thresholds + 1)[1:-1]
    f_curve = []
    for th in thresholds:
        tp = fp = fn = 0
        for fname, track in scores.items():
            sys_ev = events_at_threshold(track, event_class, th)
            ref_ev = np.array([[on, off] for on, off, _ in
                               ground_truth.get(fname, [])])
            if len(ref_ev) == 0:
                fp += len(sys_ev)
                continue
            matched = 0
            used: set = set()
            for r_on, r_off in ref_ev:
                collar = max(offset_collar,
                             offset_collar_rate * (r_off - r_on))
                for j, (s_on, s_off) in enumerate(sys_ev):
                    if j in used:
                        continue
                    if (abs(r_on - s_on) <= onset_collar
                            and abs(r_off - s_off) <= collar):
                        used.add(j)
                        matched += 1
                        break
            tp += matched
            fp += len(sys_ev) - matched
            fn += len(ref_ev) - matched
        precision = tp / max(tp + fp, 1e-15)
        recall = tp / max(tp + fn, 1e-15)
        f_curve.append(2 * precision * recall
                       / max(precision + recall, 1e-15))
    f_curve = np.asarray(f_curve)
    auc = staircase_auc(f_curve, thresholds, max_x=float(thresholds[-1]))
    return {"thresholds": thresholds, "f_curve": f_curve, "auc": auc}


def intersection_fscore_curve(scores: Dict[str, dict],
                              ground_truth: Dict[str, list],
                              dtc_threshold: float = 0.5,
                              gtc_threshold: float = 0.5,
                              num_thresholds: int = 50,
                              event_class: str = "fake_event") -> dict:
    """Intersection-criteria F1 over a threshold grid: its staircase AUC
    and best F1 (reference evaluate_intersection_auc,
    run_strong.py:1166-1207)."""
    gt = [(fname, on, off) for fname, events in ground_truth.items()
          for on, off, _ in events]
    evaluator = GroundingPrecisionRecall(
        dtc_threshold, gtc_threshold,
        table({"filename": [r[0] for r in gt], "onset": [r[1] for r in gt],
               "offset": [r[2] for r in gt]}))
    thresholds = np.linspace(0.0, 1.0, num_thresholds + 1)[1:-1]
    for th in thresholds:
        rows = [(fname, on, off) for fname, track in scores.items()
                for on, off in events_at_threshold(track, event_class, th)]
        evaluator.add_operating_point(
            table({"filename": [r[0] for r in rows],
                   "onset": [r[1] for r in rows],
                   "offset": [r[2] for r in rows]}),
            info={"threshold": th})
    p = np.asarray([op["precision"] for op in evaluator.operating_points])
    r = np.asarray([op["recall"] for op in evaluator.operating_points])
    f_curve = 2 * p * r / np.maximum(p + r, 1e-15)
    return {
        "thresholds": thresholds,
        "f_curve": f_curve,
        "score": staircase_auc(f_curve, thresholds,
                               max_x=float(thresholds[-1])),
        "f_max": float(f_curve.max()) if len(f_curve) else 0.0,
    }
