"""Evaluation without pandas: decoding, PSDS, th-AUC, sed_eval metrics and
F-score curves on tables (``tables.py``: dicts of column arrays), and the
tagging average precision without scikit-learn (``tagging.py``)."""

from texttoaudiogrounding_tpu_torch.evaluation.decode import (
    binarize,
    connect_clusters,
    decode_multi_threshold,
    double_threshold,
    find_contiguous_regions,
    median_filter,
    predictions_to_time,
)
from texttoaudiogrounding_tpu_torch.evaluation.psds import (
    PSDSEvaluator,
    compute_psds,
    compute_psds_sed_scores,
    staircase_auc,
)
from texttoaudiogrounding_tpu_torch.evaluation.sed_metrics import (
    compute_sed_eval,
    event_based_metrics,
    segment_based_metrics,
)
from texttoaudiogrounding_tpu_torch.evaluation.tagging import (
    average_precision,
)
from texttoaudiogrounding_tpu_torch.evaluation.th_auc import (
    GroundingPrecisionRecall,
    compute_th_auc,
)

__all__ = [
    "binarize", "median_filter", "connect_clusters", "double_threshold",
    "find_contiguous_regions", "predictions_to_time",
    "decode_multi_threshold", "PSDSEvaluator", "compute_psds",
    "compute_psds_sed_scores", "staircase_auc", "GroundingPrecisionRecall",
    "compute_th_auc", "compute_sed_eval", "event_based_metrics",
    "segment_based_metrics", "average_precision",
]
