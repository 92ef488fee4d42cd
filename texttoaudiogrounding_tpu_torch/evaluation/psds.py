"""PSDS (Polyphonic Sound Detection Score) on tables, without pandas.

Port of ``texttoaudiogrounding_tpu/evaluation/psds.py``, both paths:

* operating-point PSDS (psds_eval semantics, reference
  utils/eval_util.py:136-223): DTC / GTC / CTTC intersection criteria per
  operating point, each class's staircase ROC of its best operating
  points, effective TPR ``mu - alpha_st * sigma``, staircase AUC over
  ``max_efpr``;
* threshold-free PSDS over score tracks (sed_scores_eval semantics,
  reference utils/eval_util.py:226-292): the exact change-point sweep,
  single- and multi-class with cross-triggers, and the ``exact=False``
  dense grid through the operating-point evaluator.

Detections and ground truth are tables (``evaluation/tables.py``): dicts
of column arrays.  Score tracks are tables ``{onset, offset, <class>...}``
a file.  Sums run in the JAX package's orders (per-class curves stacked
in sorted class order, counts merged as threshold-sorted deltas), so the
metrics agree to rounding.  A ROC curve is written as a TSV beside where
the JAX package writes its PNG, and as the PNG too where matplotlib
imports (``tables.write_curve``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from texttoaudiogrounding_tpu_torch.evaluation.decode import (
    find_contiguous_regions,
)
from texttoaudiogrounding_tpu_torch.evaluation.tables import (
    drop,
    n_rows,
    read_duration,
    read_tsv,
    select,
    table,
    write_curve,
)

def staircase_auc(y: np.ndarray, x: np.ndarray,
                  max_x: Optional[float] = None, *,
                  monotonize: bool = False) -> float:
    """Area under a right-continuous step function of sample points, up to
    ``max_x`` (``sed_scores_eval.utils.auc.staircase_auc``), without
    re-monotonizing y unless ``monotonize`` (the single-class PSD-ROC
    envelope)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    order = np.argsort(x, kind="stable")
    x, y = x[order], y[order]
    if monotonize:
        y = np.maximum.accumulate(y)
    if max_x is None:
        max_x = x[-1] if len(x) else 0.0
    keep = x <= max_x
    x, y = x[keep], y[keep]
    if len(x) == 0:
        return 0.0
    widths = np.diff(np.r_[x, max_x])
    return float(np.sum(y * widths))


def events_at_threshold(track: dict, column: str,
                        threshold: float) -> np.ndarray:
    """A score track → ``[R, 2]`` second events at ``>= threshold``
    (sed_scores_eval binarization, no postprocessing)."""
    vals = np.asarray(track[column]) >= threshold
    if not vals.any():
        return np.zeros((0, 2))
    change = np.flatnonzero(np.diff(np.r_[0, vals.astype(np.int8), 0]))
    pairs = change.reshape(-1, 2)
    onsets = np.asarray(track["onset"])
    offsets = np.asarray(track["offset"])
    return np.stack([onsets[pairs[:, 0]], offsets[pairs[:, 1] - 1]],
                    axis=1)


def intersections(det: dict, gt: dict) -> dict:
    """Every (detection, ground truth) pair on the same file that touches
    or overlaps (psds_eval ``_ground_truth_intersections``): row indices
    ``det`` and ``gt`` (each detection's pairs in the ground truth's row
    order), ``inter``, ``det_precision`` and ``gt_coverage`` (NaN where a
    duration is 0, as pandas divides)."""
    codes: dict = {}
    dcode = np.asarray([codes.setdefault(f, len(codes))
                        for f in det["filename"]], np.int64)
    gcode = np.asarray([codes.setdefault(f, len(codes))
                        for f in gt["filename"]], np.int64)
    order = np.argsort(gcode, kind="stable")
    lo = np.searchsorted(gcode[order], dcode, "left")
    counts = np.searchsorted(gcode[order], dcode, "right") - lo
    d = np.repeat(np.arange(len(dcode)), counts)
    within = np.arange(len(d)) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    g = order[np.repeat(lo, counts) + within]
    d_on, d_off = det["onset"][d], det["offset"][d]
    g_on, g_off = gt["onset"][g], gt["offset"][g]
    touch = (d_on <= g_off) & (g_on <= d_off)
    d, g = d[touch], g[touch]
    d_on, d_off, g_on, g_off = d_on[touch], d_off[touch], g_on[touch], \
        g_off[touch]
    inter = np.minimum(d_off, g_off) - np.maximum(d_on, g_on)
    with np.errstate(divide="ignore", invalid="ignore"):
        return {"det": d, "gt": g, "inter": inter,
                "det_precision": inter / (d_off - d_on),
                "gt_coverage": inter / (g_off - g_on)}


def group_sum(index: np.ndarray, values: np.ndarray, mask: np.ndarray,
              n: int) -> tuple:
    """(sums by group over the masked pairs, NaN counted as 0 as pandas'
    ``groupby().sum()`` does; which groups have a masked pair)."""
    idx, vals = index[mask], values[mask]
    vals = np.where(np.isnan(vals), 0.0, vals)
    return (np.bincount(idx, weights=vals, minlength=n),
            np.bincount(idx, minlength=n) > 0)


def _labels(t: dict, default: str = "fake_event") -> np.ndarray:
    if "event_label" in t:
        return t["event_label"]
    return np.full(n_rows(t), default, dtype=object)


def _notnull(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind == "f":
        return ~np.isnan(values)
    return np.asarray([v is not None and v == v for v in values], bool)


class PSDSEvaluator:
    """Operating-point PSDS evaluator (psds_eval-compatible counting).
    ``ground_truth``: a table (filename, onset, offset[, event_label]);
    ``metadata``: a table (filename, duration)."""

    def __init__(self, ground_truth: dict, metadata: dict,
                 dtc_threshold: float = 0.5, gtc_threshold: float = 0.5,
                 cttc_threshold: float = 0.0):
        gt = {**ground_truth, "event_label": _labels(ground_truth)}
        gt = select(gt, _notnull(gt["onset"]) & _notnull(gt["offset"])
                    & _notnull(gt["event_label"]))
        gt["duration"] = gt["offset"] - gt["onset"]
        self.ground_truth = gt
        self.class_names = sorted(set(gt["event_label"]))
        seen: dict = {}
        for fname, dur in zip(metadata["filename"], metadata["duration"]):
            seen.setdefault(fname, dur)
        self.dataset_duration = float(np.sum(np.asarray(
            list(seen.values()), np.float64)))
        self.gt_duration_per_class = {
            c: float(np.sum(gt["duration"][gt["event_label"] == c]))
            for c in self.class_names}
        self.dtc_threshold = dtc_threshold
        self.gtc_threshold = gtc_threshold
        self.cttc_threshold = cttc_threshold
        self.operating_points: list[dict] = []

    def _counts_for_class(self, det_c: dict, cls: str) -> tuple:
        """(num_tp_gts, num_fp_dets, cross-trigger counts per other
        class)."""
        num_dets = n_rows(det_c)
        if num_dets == 0:
            return 0, 0, {}
        gt = self.ground_truth
        cross = intersections(det_c, gt)
        d, g = cross["det"], cross["gt"]
        labels = gt["event_label"][g]
        same = labels == cls
        prec, present = group_sum(d, cross["det_precision"], same, num_dets)
        dtc_valid = present & (prec >= self.dtc_threshold)
        num_fp = num_dets - int(dtc_valid.sum())
        cov, covered = group_sum(g, cross["gt_coverage"],
                                 same & dtc_valid[d], n_rows(gt))
        num_tp = int((covered & (cov >= self.gtc_threshold)).sum())

        ct_counts: dict[str, int] = {}
        if self.cttc_threshold > 0:
            failing = ~dtc_valid[d]
            for other in self.class_names:
                if other == cls:
                    continue
                prec, present = group_sum(d, cross["det_precision"],
                                          failing & (labels == other),
                                          num_dets)
                ct_counts[other] = int(
                    (present & (prec >= self.cttc_threshold)).sum())
        return num_tp, num_fp, ct_counts

    def add_operating_point(self, detections: dict,
                            info: Optional[dict] = None) -> None:
        det_labels = _labels(detections)
        gt_labels = self.ground_truth["event_label"]
        point = {"info": info or {}, "per_class": {}}
        for cls in self.class_names:
            det_c = select(detections, det_labels == cls)
            num_tp, num_fp, ct = self._counts_for_class(det_c, cls)
            num_gts = int((gt_labels == cls).sum())
            tpr = num_tp / max(num_gts, 1e-15)
            fpr = num_fp / self.dataset_duration * 3600.0  # per hour
            ctr = 0.0
            others = [c for c in self.class_names if c != cls]
            if others and self.cttc_threshold > 0:
                rates = [ct.get(other, 0)
                         / max(self.gt_duration_per_class[other], 1e-15)
                         * 3600.0 for other in others]
                ctr = float(np.mean(rates))
            point["per_class"][cls] = {"tpr": tpr, "fpr": fpr, "ctr": ctr,
                                       "tp": num_tp, "fp": num_fp}
        self.operating_points.append(point)

    def psds(self, alpha_ct: float = 0.0, alpha_st: float = 0.0,
             max_efpr: Optional[float] = None):
        """PSDS value and ROC ``(etpr, efpr)`` over the operating points."""
        if not self.operating_points:
            return 0.0, (np.zeros(1), np.zeros(1))
        per_class_points = {}
        for cls in self.class_names:
            pts = []
            for op in self.operating_points:
                st = op["per_class"][cls]
                pts.append((st["fpr"] + alpha_ct * st["ctr"], st["tpr"]))
            per_class_points[cls] = np.array(pts)
        return _psds_from_points(per_class_points, alpha_st, max_efpr)


def _psds_from_points(per_class_points: Dict[str, np.ndarray],
                      alpha_st: float, max_efpr: Optional[float]):
    """PSDS from per-class (eFPR, TPR) operating points: each class's ROC
    is the running max of TPR over ascending eFPR, resampled as steps on
    the union eFPR axis, combined as ``max(mu - alpha_st * sigma, 0)`` and
    staircase-integrated."""
    efpr_all = [pts[:, 0] for pts in per_class_points.values()]
    efpr_axis = np.unique(np.concatenate(efpr_all + [np.zeros(1)]))
    if max_efpr is None:
        max_efpr = float(efpr_axis.max()) if efpr_axis.max() > 0 else 1.0
    efpr_axis = np.r_[efpr_axis[efpr_axis < max_efpr], max_efpr]

    tpr_curves = []
    for pts in per_class_points.values():
        order = np.argsort(pts[:, 0], kind="stable")
        x = pts[order, 0]
        y = np.maximum.accumulate(pts[order, 1])
        idx = np.searchsorted(x, efpr_axis, side="right") - 1
        tpr_curves.append(np.where(idx >= 0, y[np.maximum(idx, 0)], 0.0))
    tpr_curves = np.stack(tpr_curves)            # [C, X]
    mu = tpr_curves.mean(axis=0)
    sigma = tpr_curves.std(axis=0)
    etpr = np.maximum(mu - alpha_st * sigma, 0.0)
    auc = staircase_auc(etpr, efpr_axis, max_x=max_efpr)
    return auc / max_efpr, (etpr, efpr_axis)


def save_roc(roc, save_dir, dtc, gtc, max_efpr, prefix="PSDS") -> list:
    """The ROC's points as ``<prefix>_dtc.._gtc.._maxefpr...tsv`` (and
    ``.png`` where matplotlib imports) under ``save_dir``."""
    etpr, efpr = roc
    return write_curve(
        Path(save_dir) / f"{prefix}_dtc{dtc}_gtc{gtc}_maxefpr{max_efpr}",
        "eFPR per hour", efpr, "eTPR", etpr, step=True)


def compute_psds(prediction_tables: Dict[float, dict], ground_truth,
                 duration, dtc_threshold: float = 0.5,
                 gtc_threshold: float = 0.5, cttc_threshold: float = 0.0,
                 alpha_ct: float = 0.0, alpha_st: float = 0.0,
                 max_efpr: Optional[float] = None, save_dir=None) -> float:
    """Operating-point PSDS from per-threshold detection tables (reference
    ``compute_psds``, utils/eval_util.py:136-223).  ``ground_truth`` (a
    table or a TSV path) has ``filename`` and ``audio_id``; a datapoint
    lasts as long as its audio (``duration``: a TSV path, a table or a
    mapping, ``tables.read_duration``)."""
    if not isinstance(ground_truth, dict):
        ground_truth = read_tsv(ground_truth)
    aid_to_dur = read_duration(duration)
    metadata = table({
        "filename": ground_truth["filename"],
        "duration": [aid_to_dur[str(a)] for a in ground_truth["audio_id"]]})
    evaluator = PSDSEvaluator(drop(ground_truth, "audio_id"), metadata,
                              dtc_threshold, gtc_threshold, cttc_threshold)
    for i, k in enumerate(sorted(prediction_tables)):
        evaluator.add_operating_point(
            prediction_tables[k], info={"name": f"Op {i+1:02d}",
                                        "threshold": k})
    value, roc = evaluator.psds(alpha_ct=alpha_ct, alpha_st=alpha_st,
                                max_efpr=max_efpr)
    if save_dir is not None:
        save_roc(roc, save_dir, dtc_threshold, gtc_threshold, max_efpr)
    return value


def _file_count_curves(score: np.ndarray, timestamps: np.ndarray,
                       gt_events: list, dtc: float, gtc: float,
                       use_native: bool = True) -> tuple:
    """Exact per-file TP / FP counts as step functions of the threshold,
    evaluated at each unique score (every distinct detection set): (taus
    descending, tp counts, fp counts).  ``use_native`` runs
    ``native/decode.cpp``."""
    if use_native:
        from texttoaudiogrounding_tpu_torch import native
        return native.file_count_curves(score, timestamps, gt_events, dtc,
                                        gtc)
    uniques = np.unique(score)[::-1]  # descending
    gts = np.array([[on, off] for on, off in gt_events]) \
        if gt_events else np.zeros((0, 2))
    gt_dur = (gts[:, 1] - gts[:, 0]) if len(gts) else np.zeros(0)
    tps = np.zeros(len(uniques), np.int64)
    fps = np.zeros(len(uniques), np.int64)
    for i, tau in enumerate(uniques):
        regions = find_contiguous_regions(score >= tau)
        if len(regions) == 0:
            continue
        onsets = timestamps[regions[:, 0]]
        offsets = timestamps[regions[:, 1]]
        det_dur = offsets - onsets
        if len(gts):
            inter = (np.minimum(offsets[:, None], gts[None, :, 1])
                     - np.maximum(onsets[:, None], gts[None, :, 0]))
            inter = np.maximum(inter, 0.0)              # [D, G]
            det_prec = inter.sum(1) / np.maximum(det_dur, 1e-15)
            dtc_valid = det_prec >= dtc
            coverage = inter[dtc_valid].sum(0) / np.maximum(gt_dur, 1e-15)
            tps[i] = int((coverage >= gtc).sum())
            fps[i] = int((~dtc_valid).sum())
        else:
            fps[i] = len(regions)
    return uniques, tps, fps


def _file_count_curves_mc(score: np.ndarray, timestamps: np.ndarray,
                          gt_cls: list, gt_other: Dict[str, list],
                          dtc: float, gtc: float, cttc: float,
                          use_native: bool = True) -> tuple:
    """As :func:`_file_count_curves`, and per other class the detections
    that fail DTC yet match that class's ground truths (summed precision
    ≥ ``cttc``): (taus, tps, fps, {other: cts})."""
    if use_native:
        from texttoaudiogrounding_tpu_torch import native
        return native.file_count_curves_ct(score, timestamps, gt_cls,
                                           gt_other, dtc, gtc, cttc)
    uniques = np.unique(score)[::-1]  # descending
    gts = np.array(gt_cls, np.float64).reshape(-1, 2)
    gt_dur = gts[:, 1] - gts[:, 0]
    others = {c: np.array(v, np.float64).reshape(-1, 2)
              for c, v in gt_other.items()}
    tps = np.zeros(len(uniques), np.int64)
    fps = np.zeros(len(uniques), np.int64)
    cts = {c: np.zeros(len(uniques), np.int64) for c in others}
    for i, tau in enumerate(uniques):
        regions = find_contiguous_regions(score >= tau)
        if len(regions) == 0:
            continue
        onsets = timestamps[regions[:, 0]]
        offsets = timestamps[regions[:, 1]]
        det_dur = np.maximum(offsets - onsets, 1e-15)

        def overlap(gt_arr):
            if len(gt_arr) == 0:
                return np.zeros(len(onsets))
            inter = (np.minimum(offsets[:, None], gt_arr[None, :, 1])
                     - np.maximum(onsets[:, None], gt_arr[None, :, 0]))
            return np.maximum(inter, 0.0)

        inter = overlap(gts)                       # [D, G]
        det_prec = inter.sum(1) / det_dur if len(gts) else \
            np.zeros(len(onsets))
        dtc_valid = det_prec >= dtc
        if len(gts):
            coverage = inter[dtc_valid].sum(0) / np.maximum(gt_dur, 1e-15)
            tps[i] = int((coverage >= gtc).sum())
        fps[i] = int((~dtc_valid).sum())
        if cttc > 0 and (~dtc_valid).any():
            for c, gt_arr in others.items():
                if len(gt_arr) == 0:
                    continue
                ip = overlap(gt_arr)[~dtc_valid].sum(1) \
                    / det_dur[~dtc_valid]
                cts[c][i] = int((ip >= cttc).sum())
    return uniques, tps, fps, cts


def _merge_deltas(taus_all, counts_all) -> list:
    """Per-file descending-threshold step functions → one global curve:
    deltas against the next higher threshold, summed at equal thresholds,
    cumulated over the descending sweep."""
    taus = np.concatenate(taus_all)
    uniq, inverse = np.unique(taus, return_inverse=True)
    merged = []
    for counts in counts_all:
        deltas = np.concatenate([np.diff(np.r_[0, c]) for c in counts])
        d = np.bincount(inverse, weights=deltas, minlength=len(uniq))
        merged.append(np.cumsum(d[::-1]))
    return merged  # aligned to descending uniq


def _timestamps(track: dict) -> np.ndarray:
    return np.r_[track["onset"], track["offset"][-1]]


def exact_psd_roc(scores: Dict[str, dict], ground_truth: Dict[str, list],
                  durations: Dict[str, float], dtc_threshold: float = 0.5,
                  gtc_threshold: float = 0.5, cttc_threshold: float = 0.0,
                  alpha_ct: float = 0.0, alpha_st: float = 0.0,
                  max_efpr: Optional[float] = None,
                  use_native: bool = True):
    """Exact threshold-free multi-class PSD-ROC (sed_scores_eval
    ``intersection_based.psd_roc``): per class, the counts (TP / FP /
    cross-triggers per other class) at every file's score change points,
    merged globally as threshold-sorted deltas, then combined as the
    operating-point evaluator does.  Classes: the ground truth's labels
    and the score tracks' columns."""
    total_duration = float(sum(durations.values()))
    classes = sorted({label for evs in ground_truth.values()
                      for *_, label in evs}
                     | {c for track in scores.values() for c in track
                        if c not in ("onset", "offset")})
    gt_by_fc: dict = {fname: {} for fname in scores}
    num_gts = {c: 0 for c in classes}
    gt_dur = {c: 0.0 for c in classes}
    for fname, evs in ground_truth.items():
        for on, off, label in evs:
            gt_by_fc.setdefault(fname, {}).setdefault(label, []).append(
                (on, off))
            num_gts[label] += 1
            gt_dur[label] += off - on

    use_ct = cttc_threshold > 0.0 and alpha_ct != 0.0
    per_class_points = {}
    for cls in classes:
        taus_all, tp_all, fp_all = [], [], []
        ct_all = {c: [] for c in classes if c != cls} if use_ct else {}
        for fname, track in scores.items():
            if cls not in track:
                continue
            score = np.asarray(track[cls])
            timestamps = _timestamps(track)
            by_c = gt_by_fc.get(fname, {})
            if not use_ct:
                taus, tps, fps = _file_count_curves(
                    score, timestamps, by_c.get(cls, []), dtc_threshold,
                    gtc_threshold, use_native)
            else:
                taus, tps, fps, cts = _file_count_curves_mc(
                    score, timestamps, by_c.get(cls, []),
                    {c: by_c.get(c, []) for c in ct_all}, dtc_threshold,
                    gtc_threshold, cttc_threshold, use_native)
                for c in ct_all:
                    ct_all[c].append(cts[c])
            taus_all.append(taus)
            tp_all.append(tps)
            fp_all.append(fps)
        if not taus_all:
            per_class_points[cls] = np.zeros((1, 2))
            continue
        merged = _merge_deltas(
            taus_all, [tp_all, fp_all] + [ct_all[c] for c in ct_all])
        tp, fp = merged[0], merged[1]
        tpr = tp / max(num_gts[cls], 1e-15)
        efpr = fp / max(total_duration, 1e-15) * 3600.0
        if ct_all and cttc_threshold > 0 and alpha_ct != 0.0:
            rates = [merged[2 + k] / max(gt_dur[c], 1e-15) * 3600.0
                     for k, c in enumerate(ct_all)]
            efpr = efpr + alpha_ct * np.mean(rates, axis=0)
        per_class_points[cls] = np.stack([efpr, tpr], axis=1)
    return _psds_from_points(per_class_points, alpha_st, max_efpr)


def exact_single_class_psd_roc(scores: Dict[str, dict],
                               ground_truth: Dict[str, list],
                               durations: Dict[str, float],
                               dtc_threshold: float = 0.5,
                               gtc_threshold: float = 0.5,
                               max_efpr: Optional[float] = None,
                               event_class: str = "fake_event",
                               use_native: bool = True):
    """Threshold-free single-class PSDS: per-file step-function TP / FP
    counts merged as deltas sorted by descending threshold, the ROC
    monotonized as sed_scores_eval does for one class."""
    total_duration = float(sum(durations.values()))
    num_gts = sum(len(v) for v in ground_truth.values())
    taus_all, dtp_all, dfp_all = [], [], []
    for fname, track in scores.items():
        gt_events = [(on, off) for on, off, *_ in
                     ground_truth.get(fname, [])]
        taus, tps, fps = _file_count_curves(
            np.asarray(track[event_class]), _timestamps(track), gt_events,
            dtc_threshold, gtc_threshold, use_native)
        taus_all.append(taus)
        dtp_all.append(np.diff(np.r_[0, tps]))
        dfp_all.append(np.diff(np.r_[0, fps]))
    if not taus_all:
        return 0.0, (np.zeros(1), np.zeros(1))
    # sum the deltas at equal thresholds first: one at a time would make
    # operating points that do not exist
    uniq, inverse = np.unique(np.concatenate(taus_all), return_inverse=True)
    tp_d = np.bincount(inverse, weights=np.concatenate(dtp_all),
                       minlength=len(uniq))
    fp_d = np.bincount(inverse, weights=np.concatenate(dfp_all),
                       minlength=len(uniq))
    tp = np.cumsum(tp_d[::-1])
    fp = np.cumsum(fp_d[::-1])
    tpr = tp / max(num_gts, 1e-15)
    efpr = fp / max(total_duration, 1e-15) * 3600.0
    if max_efpr is None:
        max_efpr = float(efpr.max()) if efpr.max() > 0 else 1.0
    auc = staircase_auc(tpr, efpr, max_x=max_efpr, monotonize=True)
    return auc / max_efpr, (tpr, efpr)


def compute_psds_sed_scores(scores: Dict[str, dict],
                            ground_truth: Dict[str, list], duration,
                            fname_to_aid: Dict[str, str],
                            dtc_threshold: float = 0.5,
                            gtc_threshold: float = 0.5,
                            cttc_threshold: float = 0.0,
                            alpha_ct: float = 0.0, alpha_st: float = 0.0,
                            max_efpr: Optional[float] = None,
                            num_thresholds: int = 200, exact: bool = True,
                            save_dir=None, use_native: bool = True) -> float:
    """Threshold-resolved PSDS over score tracks (reference
    ``compute_psds_sed_scores``, utils/eval_util.py:250-292):
    ``scores[fname]`` a table (onset, offset, <event>...),
    ``ground_truth[fname]`` a list of (onset, offset, event).  Exact
    change-point enumeration (``>= threshold``, no median filter);
    ``exact=False`` runs a uniform ``num_thresholds`` grid through the
    operating-point evaluator."""
    aid_to_dur = read_duration(duration)
    durations = {fname: aid_to_dur[str(fname_to_aid[fname])]
                 for fname in scores}
    event_cols_set = {tuple(c for c in track if c not in ("onset", "offset"))
                      for track in scores.values()}
    if (len(event_cols_set) == 1 and len(next(iter(event_cols_set))) == 1
            and alpha_ct == 0.0 and alpha_st == 0.0
            and cttc_threshold == 0.0):
        value, roc = exact_single_class_psd_roc(
            scores, ground_truth, durations, dtc_threshold=dtc_threshold,
            gtc_threshold=gtc_threshold, max_efpr=max_efpr,
            event_class=next(iter(event_cols_set))[0],
            use_native=use_native)
    elif exact:
        value, roc = exact_psd_roc(
            scores, ground_truth, durations, dtc_threshold=dtc_threshold,
            gtc_threshold=gtc_threshold, cttc_threshold=cttc_threshold,
            alpha_ct=alpha_ct, alpha_st=alpha_st, max_efpr=max_efpr,
            use_native=use_native)
    else:
        gt = table({
            "filename": [f for f, evs in ground_truth.items() for _ in evs],
            "onset": [e[0] for evs in ground_truth.values() for e in evs],
            "offset": [e[1] for evs in ground_truth.values() for e in evs],
            "event_label": [e[2] for evs in ground_truth.values()
                            for e in evs]})
        metadata = table({
            "filename": list(ground_truth),
            "duration": [aid_to_dur[str(fname_to_aid[f])]
                         for f in ground_truth]})
        evaluator = PSDSEvaluator(gt, metadata, dtc_threshold,
                                  gtc_threshold, cttc_threshold)
        for th in np.linspace(0.0, 1.0, num_thresholds + 1)[1:-1]:
            rows = [(fname, col, on, off)
                    for fname, track in scores.items()
                    for col in track if col not in ("onset", "offset")
                    for on, off in events_at_threshold(track, col, th)]
            evaluator.add_operating_point(
                table({"filename": [r[0] for r in rows],
                       "event_label": [r[1] for r in rows],
                       "onset": [r[2] for r in rows],
                       "offset": [r[3] for r in rows]}),
                info={"threshold": th})
        value, roc = evaluator.psds(alpha_ct=alpha_ct, alpha_st=alpha_st,
                                    max_efpr=max_efpr)
    if save_dir is not None:
        save_roc(roc, save_dir, dtc_threshold, gtc_threshold, max_efpr,
                 prefix="PSDS_sedscores")
    return value
