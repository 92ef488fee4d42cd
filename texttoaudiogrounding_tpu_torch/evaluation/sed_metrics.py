"""Event-based and segment-based SED metrics (sed_eval semantics).

Port of ``texttoaudiogrounding_tpu/evaluation/sed_metrics.py`` (reference
utils/eval_util.py:354-425) on tables (filename, onset, offset,
event_label): event-based F1 with an onset collar and an offset collar of
``max(t_collar, percentage_of_length * gt_length)``, and segment-based F1
on a fixed time grid; micro (instance-pooled) and macro (class-averaged).
"""

from __future__ import annotations

import numpy as np

from texttoaudiogrounding_tpu_torch.evaluation.psds import _notnull


def _f_measure(tp: float, fp: float, fn: float) -> dict:
    precision = tp / max(tp + fp, 1e-15)
    recall = tp / max(tp + fn, 1e-15)
    f = 2 * precision * recall / max(precision + recall, 1e-15)
    return {"f_measure": f, "precision": precision, "recall": recall}


def _match_events(ref: np.ndarray, sys: np.ndarray, t_collar: float,
                  percentage_of_length: float) -> int:
    """Greedy unique matching of [R, 2] ref against [S, 2] sys events
    (sed_eval ``EventBasedMetrics``)."""
    matched_sys: set[int] = set()
    num_tp = 0
    for r_on, r_off in ref:
        offset_collar = max(t_collar, percentage_of_length * (r_off - r_on))
        for j, (s_on, s_off) in enumerate(sys):
            if j in matched_sys:
                continue
            if (abs(r_on - s_on) <= t_collar
                    and abs(r_off - s_off) <= offset_collar):
                matched_sys.add(j)
                num_tp += 1
                break
    return num_tp


def _classes(reference: dict, estimated: dict) -> list:
    labels = [t["event_label"] for t in (reference, estimated)]
    return sorted(set(v for lab in labels for v in lab[_notnull(lab)]))


def _events(t: dict, mask: np.ndarray) -> np.ndarray:
    return np.stack([t["onset"][mask], t["offset"][mask]], axis=1)


def event_based_metrics(reference: dict, estimated: dict,
                        t_collar: float = 0.2,
                        percentage_of_length: float = 0.2) -> dict:
    """Event-based metrics (reference utils/eval_util.py:354-391)."""
    per_class = {}
    tot_tp = tot_fp = tot_fn = 0
    for cls in _classes(reference, estimated):
        tp = fp = fn = 0
        ref_c = reference["event_label"] == cls
        sys_c = estimated["event_label"] == cls
        files = set(reference["filename"][ref_c]) \
            | set(estimated["filename"][sys_c])
        for fname in files:
            ref_ev = _events(reference,
                             ref_c & (reference["filename"] == fname))
            sys_ev = _events(estimated,
                             sys_c & (estimated["filename"] == fname))
            ntp = _match_events(ref_ev, sys_ev, t_collar,
                                percentage_of_length)
            tp += ntp
            fp += len(sys_ev) - ntp
            fn += len(ref_ev) - ntp
        per_class[cls] = _f_measure(tp, fp, fn)
        tot_tp += tp
        tot_fp += fp
        tot_fn += fn
    macro = float(np.mean([v["f_measure"] for v in per_class.values()])
                  ) if per_class else 0.0
    return {"overall": _f_measure(tot_tp, tot_fp, tot_fn),
            "class_wise_average": {"f_measure": macro},
            "class_wise": per_class}


def segment_based_metrics(reference: dict, estimated: dict,
                          time_resolution: float = 1.0) -> dict:
    """Segment-based metrics on a fixed grid (reference
    utils/eval_util.py:394-415)."""
    classes = _classes(reference, estimated)
    files = sorted(set(reference["filename"]) | set(estimated["filename"]))
    per_class_counts = {c: [0, 0, 0] for c in classes}  # tp, fp, fn
    for fname in files:
        ref_f = reference["filename"] == fname
        sys_f = estimated["filename"] == fname
        max_t = max(
            float(reference["offset"][ref_f].max()) if ref_f.any() else 0.0,
            float(estimated["offset"][sys_f].max()) if sys_f.any() else 0.0)
        num_seg = int(np.ceil(max_t / time_resolution)) if max_t > 0 else 0
        if num_seg == 0:
            continue
        grid = np.arange(num_seg) * time_resolution
        for cls in classes:
            acts = []
            for t, f_mask in ((reference, ref_f), (estimated, sys_f)):
                act = np.zeros(num_seg, bool)
                for onset, offset in _events(
                        t, f_mask & (t["event_label"] == cls)):
                    act |= (grid + time_resolution > onset) & \
                           (grid < offset)
                acts.append(act)
            ref_act, sys_act = acts
            counts = per_class_counts[cls]
            counts[0] += int((ref_act & sys_act).sum())
            counts[1] += int((~ref_act & sys_act).sum())
            counts[2] += int((ref_act & ~sys_act).sum())
    per_class = {c: _f_measure(*v) for c, v in per_class_counts.items()}
    tot = np.sum(list(per_class_counts.values()), axis=0) \
        if per_class_counts else np.zeros(3)
    macro = float(np.mean([v["f_measure"] for v in per_class.values()])
                  ) if per_class else 0.0
    return {"overall": _f_measure(*tot),
            "class_wise_average": {"f_measure": macro},
            "class_wise": per_class}


def compute_sed_eval(valid: dict, pred: dict, t_collar: float = 0.2,
                     time_resolution: float = 1.0) -> tuple[dict, dict]:
    """Reference ``compute_sed_eval`` (utils/eval_util.py:418-425)."""
    event = event_based_metrics(valid, pred, t_collar=t_collar,
                                percentage_of_length=0.2)
    segment = segment_based_metrics(valid, pred,
                                    time_resolution=time_resolution)
    return event, segment
