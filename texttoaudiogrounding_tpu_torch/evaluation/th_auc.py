"""Grounding threshold-AUC: the area under F-score against threshold.

Port of ``texttoaudiogrounding_tpu/evaluation/th_auc.py`` (reference
utils/eval_util.py:295-332 and ``Grounding_PrecisionRecall`` :431-663) on
tables: TP criteria under DTC / GTC intersection matching for one class,
the F1(threshold) curve integrated with the trapezoid rule over a
threshold range and divided by its width.  ``save_dir`` gets the
operating points as a TSV, and the F-against-threshold curve as a TSV and,
where matplotlib imports, a PNG (``tables.write_curve``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from texttoaudiogrounding_tpu_torch.evaluation.psds import (
    group_sum,
    intersections,
)
from texttoaudiogrounding_tpu_torch.evaluation.tables import (
    n_rows,
    read_tsv,
    select,
    table,
    write_curve,
    write_tsv,
)


def _by_file_onset(t: dict) -> np.ndarray:
    """The stable order by (filename, onset), as pandas ``sort_values``."""
    names = sorted(set(t["filename"]))
    rank = {name: i for i, name in enumerate(names)}
    codes = np.asarray([rank[f] for f in t["filename"]], np.int64)
    return np.lexsort((t["onset"], codes))


class GroundingPrecisionRecall:
    """Accumulates (precision, recall) per operating point
    (reference utils/eval_util.py:431-652).  ``ground_truth``: a table
    (filename, onset, offset)."""

    def __init__(self, dtc_threshold: float, gtc_threshold: float,
                 ground_truth: dict):
        if not 0.0 <= dtc_threshold <= 1.0:
            raise ValueError("dtc_threshold must be between 0 and 1")
        if not 0.0 <= gtc_threshold <= 1.0:
            raise ValueError("gtc_threshold must be between 0 and 1")
        self.dtc_threshold = dtc_threshold
        self.gtc_threshold = gtc_threshold
        self.eps = 1e-15
        gt = {k: ground_truth[k] for k in ("filename", "onset", "offset")}
        gt = select(gt, ~np.isnan(gt["onset"]) & ~np.isnan(gt["offset"]))
        self.ground_truth = select(gt, _by_file_onset(gt))
        self.operating_points: list[dict] = []

    def _evaluate_detections(self, det: dict) -> tuple:
        det = select(det, _by_file_onset(det))
        gt = self.ground_truth
        cross = intersections(det, gt)
        num_refs, num_preds = n_rows(gt), n_rows(det)
        d, g = cross["det"], cross["gt"]
        if len(d) == 0:
            return 0.0, 0.0
        every = np.ones(len(d), bool)
        # recall (reference :559-591): detections that satisfy DTC, then
        # ground truths covered >= gtc by those detections
        prec, present = group_sum(d, cross["det_precision"], every,
                                  num_preds)
        dtc_ok = present & (prec >= self.dtc_threshold)
        cov, covered = group_sum(g, cross["gt_coverage"], dtc_ok[d],
                                 num_refs)
        num_tp_refs = int((covered & (cov >= self.gtc_threshold)).sum())
        # precision (reference :594-626): ground truths covered >= gtc by
        # every detection, then detections whose precision over those
        # ground truths is >= dtc
        cov, covered = group_sum(g, cross["gt_coverage"], every, num_refs)
        gtc_ok = covered & (cov >= self.gtc_threshold)
        prec, present = group_sum(d, cross["det_precision"], gtc_ok[g],
                                  num_preds)
        num_tp_preds = int((present & (prec >= self.dtc_threshold)).sum())
        recall = num_tp_refs / max(num_refs, self.eps)
        precision = num_tp_preds / max(num_preds, self.eps)
        return precision, recall

    def add_operating_point(self, detections: dict,
                            info: Optional[dict] = None) -> None:
        info = dict(info or {})
        if n_rows(detections) == 0:
            precision, recall = 0.0, 0.0
        else:
            precision, recall = self._evaluate_detections(detections)
        self.operating_points.append(
            {"precision": precision, "recall": recall, **info})

    def _curve(self, beta: float) -> tuple:
        """(thresholds, precision, recall, F-beta) over the points."""
        ops = self.operating_points
        p = np.asarray([op["precision"] for op in ops], np.float64)
        r = np.asarray([op["recall"] for op in ops], np.float64)
        f = (1 + beta**2) * p * r / np.maximum(beta**2 * p + r, self.eps)
        th = np.asarray([op.get("threshold", np.nan) for op in ops],
                        np.float64)
        return th, p, r, f

    def th_auc(self, beta: float = 1.0, low_th: float = 0.0,
               high_th: float = 1.0) -> float:
        """F-beta-against-threshold trapezoid AUC / (high_th - low_th)
        (reference utils/eval_util.py:640-652)."""
        th, _, _, f = self._curve(beta)
        keep = (th >= low_th) & (th <= high_th)
        order = np.argsort(th[keep])
        score = float(np.trapezoid(f[keep][order], th[keep][order]))
        return score / (high_th - low_th)

    def best_fscore(self, beta: float = 1.0) -> dict:
        th, p, r, f = self._curve(beta)
        i = int(np.argmax(f))
        return {"f_score": float(f[i]), "threshold": float(th[i]),
                "precision": float(p[i]), "recall": float(r[i])}


def compute_th_auc(prediction_tables: Dict[float, dict], ground_truth,
                   dtc_threshold: float = 0.5, gtc_threshold: float = 0.5,
                   min_threshold: float = 0.0, max_threshold: float = 1.0,
                   beta: float = 1.0, save_dir=None) -> float:
    """Reference ``compute_th_auc`` (utils/eval_util.py:295-332):
    ``ground_truth`` a table or a TSV path."""
    if not isinstance(ground_truth, dict):
        ground_truth = read_tsv(ground_truth)
    evaluator = GroundingPrecisionRecall(dtc_threshold, gtc_threshold,
                                         ground_truth)
    for i, k in enumerate(sorted(prediction_tables)):
        evaluator.add_operating_point(
            prediction_tables[k], info={"name": f"Op {i+1:02d}",
                                        "threshold": k})
    value = evaluator.th_auc(beta=beta, low_th=min_threshold,
                             high_th=max_threshold)
    if save_dir is not None:
        save_dir = Path(save_dir)
        ops = evaluator.operating_points
        write_tsv(table({key: [op[key] for op in ops] for key in ops[0]}),
                  save_dir / f"op_table_dtc{dtc_threshold}_gtc"
                             f"{gtc_threshold}.csv", float_format="%.3f")
        th, _, _, f = evaluator._curve(beta)
        order = np.argsort(th)
        write_curve(save_dir / "f_vs_th", "threshold", th[order], "f_score",
                    f[order], figsize=(14, 5), ylim=(0.0, 1.0),
                    savefig_args={"dpi": 150, "bbox_inches": "tight"})
    return value
