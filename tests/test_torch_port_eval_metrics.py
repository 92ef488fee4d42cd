"""The port's evaluation metrics against the JAX package's, without pandas
on the port's side.

The same numpy inputs go through both: the port's tables (dicts of column
arrays) and, for the JAX functions, the DataFrames made from them.  The
scenario is ``tests/synthetic.py:make_metric_golden_scenario`` (8 files x
125 frames, 3 classes, imperfect score tracks, 21 operating points), cut
to one class where the metric is single-class.  Tolerance 1e-9 absolute
on every metric; the native decoders equal the NumPy versions bit for bit
(segments and counts), and the port's NumPy versions equal JAX's (whose
NumPy paths are used throughout: the JAX package's native library builds
in place, which its own tests must not be raced on).  The
hand goldens of ``tests/test_metric_hand_goldens.py`` run through the port
with their hand-derived values.
"""

import sys

import numpy as np
import pandas as pd
import pytest

from tests.synthetic import make_metric_golden_scenario
from texttoaudiogrounding_tpu.evaluation import curves as jcurves
from texttoaudiogrounding_tpu.evaluation import decode as jdecode
from texttoaudiogrounding_tpu.evaluation import psds as jpsds
from texttoaudiogrounding_tpu.evaluation import sed_metrics as jsed
from texttoaudiogrounding_tpu.evaluation import th_auc as jth
from texttoaudiogrounding_tpu import native as jnative
from texttoaudiogrounding_tpu_torch import native
from texttoaudiogrounding_tpu_torch.evaluation import curves, decode, psds
from texttoaudiogrounding_tpu_torch.evaluation import sed_metrics, th_auc
from texttoaudiogrounding_tpu_torch.evaluation.tables import (
    read_tsv,
    table,
)

TOL = 1e-9


def _table(df: pd.DataFrame) -> dict:
    return table({c: df[c].to_numpy() for c in df.columns})


def _tracks(scores: dict, classes=None) -> dict:
    """DataFrame score tracks → the port's track tables (some classes)."""
    return {f: {c: df[c].to_numpy() for c in df.columns
                if classes is None or c in ("onset", "offset")
                or c in classes}
            for f, df in scores.items()}


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_paths():
    """The JAX functions on their NumPy paths: the JAX package's native
    library builds in place, which workers running its own tests at the
    same time must not race."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "get_lib", lambda: None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def scenario():
    return make_metric_golden_scenario()


def _one_class(sc, cls="dog"):
    """The scenario's ``cls`` alone, labelled ``fake_event``."""
    scores = {f: pd.DataFrame({"onset": df.onset, "offset": df.offset,
                               "fake_event": df[cls]})
              for f, df in sc["scores"].items()}
    gt = {f: [(on, off, "fake_event") for on, off, lab in evs
              if lab == cls] for f, evs in sc["ground_truth"].items()}
    preds = {th: df[df.event_label == cls].assign(event_label="fake_event")
             .reset_index(drop=True)
             for th, df in sc["prediction_dfs"].items()}
    gt_df = sc["gt_df_aid"][sc["gt_df_aid"].event_label == cls].assign(
        event_label="fake_event").reset_index(drop=True)
    return scores, gt, preds, gt_df


# ------------------------------------------------- operating-point PSDS

PSDS_OP = [  # (classes, dtc, gtc, cttc, alpha_ct, alpha_st, max_efpr)
    ("one", 0.5, 0.5, 0.0, 0.0, 0.0, 400.0),
    ("one", 0.1, 0.1, 0.0, 0.0, 0.0, None),
    ("all", 0.5, 0.5, 0.0, 0.0, 0.0, 100.0),
    ("all", 0.3, 0.3, 0.3, 0.5, 1.0, 400.0),
]


@pytest.mark.parametrize("case", PSDS_OP, ids=[str(c) for c in PSDS_OP])
def test_operating_point_psds_matches_jax(scenario, case):
    which, dtc, gtc, cttc, a_ct, a_st, max_efpr = case
    if which == "one":
        _, _, preds, gt_df = _one_class(scenario)
    else:
        preds, gt_df = scenario["prediction_dfs"], scenario["gt_df_aid"]
    # every other operating point: JAX's pandas work grows with them
    preds = {k: preds[k] for k in sorted(preds)[::2]}
    kw = dict(dtc_threshold=dtc, gtc_threshold=gtc, cttc_threshold=cttc,
              alpha_ct=a_ct, alpha_st=a_st, max_efpr=max_efpr)
    ref = jpsds.compute_psds(preds, gt_df, scenario["duration_df"], **kw)
    got = psds.compute_psds({k: _table(v) for k, v in preds.items()},
                            _table(gt_df), _table(scenario["duration_df"]),
                            **kw)
    assert 0.0 < ref < 1.0
    assert abs(got - ref) <= TOL


def test_operating_point_counts_match_jax(scenario):
    gt = scenario["gt_df"]
    meta = scenario["metadata_df"]
    jev = jpsds.PSDSEvaluator(gt, meta, 0.5, 0.5, 0.3)
    ev = psds.PSDSEvaluator(_table(gt), _table(meta), 0.5, 0.5, 0.3)
    for th in (0.3, 0.6, 0.9):
        jev.add_operating_point(scenario["prediction_dfs"][th])
        ev.add_operating_point(_table(scenario["prediction_dfs"][th]))
    assert ev.class_names == jev.class_names
    assert ev.dataset_duration == jev.dataset_duration
    for op, jop in zip(ev.operating_points, jev.operating_points):
        for cls, st in jop["per_class"].items():
            for key, value in st.items():
                assert abs(op["per_class"][cls][key] - value) <= TOL, key


# -------------------------------------------------- threshold-free PSDS

PSDS_SS = [  # (classes, cttc, alpha_ct, alpha_st, exact, max_efpr)
    ("one", 0.0, 0.0, 0.0, True, 400.0),
    ("one", 0.0, 0.0, 0.0, True, None),
    ("one", 0.0, 0.0, 0.5, False, 1000.0),
    ("all", 0.0, 0.0, 0.0, True, 100.0),
    ("all", 0.3, 0.5, 1.0, True, 400.0),
    ("all", 0.3, 0.5, 1.0, False, 1000.0),
]


@pytest.mark.parametrize("case", PSDS_SS, ids=[str(c) for c in PSDS_SS])
def test_threshold_free_psds_matches_jax(scenario, case):
    """Both sweeps of the port (native and NumPy) against JAX's."""
    which, cttc, a_ct, a_st, exact, max_efpr = case
    if which == "one":
        scores, gt, _, _ = _one_class(scenario)
    else:
        scores, gt = scenario["scores"], scenario["ground_truth"]
    kw = dict(dtc_threshold=0.5, gtc_threshold=0.5, cttc_threshold=cttc,
              alpha_ct=a_ct, alpha_st=a_st, max_efpr=max_efpr, exact=exact,
              num_thresholds=20)
    ref = jpsds.compute_psds_sed_scores(
        scores, gt, scenario["duration_df"], scenario["fname_to_aid"], **kw)
    assert 0.0 < ref < 1.0
    for native_sweep in ((True, False) if exact else (False,)):
        got = psds.compute_psds_sed_scores(
            _tracks(scores), gt, _table(scenario["duration_df"]),
            scenario["fname_to_aid"], use_native=native_sweep, **kw)
        assert abs(got - ref) <= TOL, native_sweep


def test_native_count_sweeps_equal_numpy_and_jax(scenario):
    gt = scenario["ground_truth"]
    for fname, df in scenario["scores"].items():
        ts = np.r_[df.onset.to_numpy(), df.offset.to_numpy()[-1]]
        for cls in scenario["classes"]:
            score = df[cls].to_numpy().astype(np.float32)   # as evaluated
            mine = [(on, off) for on, off, lab in gt[fname] if lab == cls]
            other = {c: [(on, off) for on, off, lab in gt[fname]
                         if lab == c]
                     for c in scenario["classes"] if c != cls}
            nat = psds._file_count_curves(score, ts, mine, 0.5, 0.5, True)
            ref = psds._file_count_curves(score, ts, mine, 0.5, 0.5, False)
            jref = jpsds._file_count_curves(score, ts, mine, 0.5, 0.5)
            for a, b, c in zip(nat, ref, jref):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(b, c)
            nat = psds._file_count_curves_mc(score, ts, mine, other, 0.5,
                                             0.5, 0.3, True)
            ref = psds._file_count_curves_mc(score, ts, mine, other, 0.5,
                                             0.5, 0.3, False)
            for a, b in zip(nat[:3], ref[:3]):
                np.testing.assert_array_equal(a, b)
            for c in other:
                np.testing.assert_array_equal(nat[3][c], ref[3][c])


# --------------------------------------------------------------- th-AUC

@pytest.mark.parametrize("dtc_gtc", [0.5, 0.3])
@pytest.mark.parametrize("span", [(0.0, 1.0), (0.2, 0.8)],
                         ids=["0-1", "0.2-0.8"])
def test_th_auc_matches_jax(scenario, span, dtc_gtc):
    _, _, preds, gt_df = _one_class(scenario)
    gt_df = gt_df.drop(columns=["event_label", "audio_id"])
    kw = dict(dtc_threshold=dtc_gtc, gtc_threshold=dtc_gtc,
              min_threshold=span[0], max_threshold=span[1])
    ref = jth.compute_th_auc(preds, gt_df, **kw)
    got = th_auc.compute_th_auc({k: _table(v) for k, v in preds.items()},
                                _table(gt_df), **kw)
    assert 0.0 < ref < 1.0
    assert abs(got - ref) <= TOL


def test_best_fscore_and_points_match_jax(scenario, tmp_path):
    _, _, preds, gt_df = _one_class(scenario)
    gt_df = gt_df.drop(columns=["event_label", "audio_id"])
    jev = jth.GroundingPrecisionRecall(0.5, 0.5, gt_df)
    ev = th_auc.GroundingPrecisionRecall(0.5, 0.5, _table(gt_df))
    for th in sorted(preds):
        jev.add_operating_point(preds[th], info={"threshold": th})
        ev.add_operating_point(_table(preds[th]), info={"threshold": th})
    for op, jop in zip(ev.operating_points, jev.operating_points):
        assert abs(op["precision"] - jop["precision"]) <= TOL
        assert abs(op["recall"] - jop["recall"]) <= TOL
    best, jbest = ev.best_fscore(), jev.best_fscore()
    assert best.keys() == jbest.keys()
    for key in best:
        assert abs(best[key] - jbest[key]) <= TOL
    # the files beside, without matplotlib: the operating points and the
    # F curve as TSVs, no PNG
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        th_auc.compute_th_auc({k: _table(v) for k, v in preds.items()},
                              _table(gt_df), save_dir=tmp_path)
    ops = read_tsv(tmp_path / "op_table_dtc0.5_gtc0.5.csv")
    assert len(ops["precision"]) == len(preds)
    curve = read_tsv(tmp_path / "f_vs_th.tsv")
    np.testing.assert_allclose(np.asarray(curve["f_score"], float),
                               ev._curve(1.0)[3], rtol=0, atol=1e-12)
    assert not (tmp_path / "f_vs_th.png").exists()


# ------------------------------------------------------------ sed_eval

@pytest.mark.parametrize("th,collar,res", [(0.3, 0.2, 1.0),
                                           (0.6, 0.5, 0.5),
                                           (0.9, 0.2, 1.0)])
def test_sed_eval_metrics_match_jax(scenario, th, collar, res):
    gt, det = scenario["gt_df"], scenario["prediction_dfs"][th]
    jevent, jsegment = jsed.compute_sed_eval(gt, det, t_collar=collar,
                                             time_resolution=res)
    event, segment = sed_metrics.compute_sed_eval(
        _table(gt), _table(det), t_collar=collar, time_resolution=res)
    for got, ref in ((event, jevent), (segment, jsegment)):
        assert got["class_wise"].keys() == ref["class_wise"].keys()
        for key in ("f_measure", "precision", "recall"):
            assert abs(got["overall"][key] - ref["overall"][key]) <= TOL
            for cls in ref["class_wise"]:
                assert abs(got["class_wise"][cls][key]
                           - ref["class_wise"][cls][key]) <= TOL
        assert abs(got["class_wise_average"]["f_measure"]
                   - ref["class_wise_average"]["f_measure"]) <= TOL


# -------------------------------------------------------------- curves

@pytest.mark.parametrize("n_thresholds", [10, 30])
def test_fscore_curves_match_jax(scenario, n_thresholds):
    scores, gt, _, _ = _one_class(scenario)
    ref = jcurves.collar_fscore_curve(scores, gt,
                                      num_thresholds=n_thresholds)
    got = curves.collar_fscore_curve(_tracks(scores), gt,
                                     num_thresholds=n_thresholds)
    np.testing.assert_allclose(got["f_curve"], ref["f_curve"], rtol=0,
                               atol=TOL)
    assert abs(got["auc"] - ref["auc"]) <= TOL and ref["auc"] > 0
    ref = jcurves.intersection_fscore_curve(scores, gt,
                                            num_thresholds=n_thresholds)
    got = curves.intersection_fscore_curve(_tracks(scores), gt,
                                           num_thresholds=n_thresholds)
    np.testing.assert_allclose(got["f_curve"], ref["f_curve"], rtol=0,
                               atol=TOL)
    assert abs(got["score"] - ref["score"]) <= TOL
    assert abs(got["f_max"] - ref["f_max"]) <= TOL and ref["f_max"] > 0


# ------------------------------------------------------------ decoding

@pytest.mark.parametrize("window,connect_n,length", [
    (1, 13, 250), (3, 1, 250), (5, 2, 37), (7, 0, 1), (1, 13, 2)])
def test_decode_multi_threshold_native_numpy_and_jax(window, connect_n,
                                                     length):
    rng = np.random.default_rng(length + window)
    scores = np.convolve(rng.random(length + 4), np.ones(5) / 5,
                         "valid").astype(np.float32)
    thresholds = np.arange(1 / 100, 1, 1 / 50)
    nat = decode.decode_multi_threshold(scores, thresholds, window,
                                        connect_n, 0.04, use_native=True)
    ref = decode.decode_multi_threshold(scores, thresholds, window,
                                        connect_n, 0.04, use_native=False)
    jref = jdecode.decode_multi_threshold(scores, thresholds, window,
                                          connect_n, 0.04, use_native=False)
    assert len(nat) == len(ref) == len(jref) == len(thresholds)
    assert any(len(r) for r in ref)
    for a, b, c in zip(nat, ref, jref):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("shape", [(60,), (60, 3), (2, 60, 3)])
def test_double_threshold_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.random(shape)
    for high, low, n in ((0.8, 0.4, 1), (0.7, 0.5, 3)):
        np.testing.assert_array_equal(
            decode.double_threshold(x, high, low, n),
            jdecode.double_threshold(x, high, low, n))
    np.testing.assert_array_equal(decode.connect_clusters(x > 0.5, 2),
                                  jdecode.connect_clusters(x > 0.5, 2))
    if x.ndim == 3:
        binary = decode.double_threshold(x, 0.8, 0.4)
        assert decode.decode_with_timestamps(["a", "b", "c"], binary) == \
            jdecode.decode_with_timestamps(["a", "b", "c"], binary)
        frames = {"onset": np.array([1.0, 7.0]), "offset": [3.0, 9.0]}
        ref = jdecode.predictions_to_time(pd.DataFrame(frames), 0.04)
        got = decode.predictions_to_time(table(frames), 0.04)
        np.testing.assert_array_equal(got["onset"], ref.onset)
        np.testing.assert_array_equal(got["offset"], ref.offset)


def test_native_library_is_built_by_rename():
    """The library lands under its hash name, with no temporary left."""
    path = native.build()
    assert path == native.lib_path() and path.is_file()
    assert not list(path.parent.glob("libttgdecode-*.tmp"))


# --------------------------------------------------------- hand goldens

def _ev(rows, cols=("filename", "onset", "offset", "event_label")):
    return table({c: [r[i] for r in rows] for i, c in enumerate(cols)})


def _hand_op_single():
    gt = _ev([("f1", 0.0, 5.0, "a"), ("f2", 10.0, 14.0, "a")])
    gt["audio_id"] = table({"a": ["a1", "a2"]})["a"]
    preds = {0.5: _ev([("f1", 0.0, 5.0, "a"), ("f2", 10.0, 14.0, "a"),
                       ("f2", 20.0, 22.0, "a")]),
             0.9: _ev([("f1", 0.0, 5.0, "a")])}
    value = psds.compute_psds(preds, gt, {"a1": 3600.0, "a2": 3600.0},
                              max_efpr=100.0)
    return value, (0.5 * 0.5 + 99.5 * 1.0) / 100.0


def _hand_op_cttc():
    gt = _ev([("f1", 0.0, 10.0, "a"), ("f1", 100.0, 110.0, "b"),
              ("f2", 0.0, 10.0, "a"), ("f2", 50.0, 60.0, "b")])
    gt["audio_id"] = table({"a": ["a1", "a1", "a2", "a2"]})["a"]
    preds = {0.5: _ev([("f1", 0.0, 10.0, "a"), ("f2", 0.0, 10.0, "a"),
                       ("f2", 50.0, 58.0, "a"), ("f1", 100.0, 110.0, "b"),
                       ("f2", 50.0, 60.0, "b")]),
             0.9: _ev([("f1", 0.0, 10.0, "a"), ("f2", 50.0, 60.0, "b")])}
    value = psds.compute_psds(preds, gt, {"a1": 3600.0, "a2": 3600.0},
                              cttc_threshold=0.3, alpha_ct=0.5,
                              alpha_st=1.0, max_efpr=100.0)
    return value, (0.5 * 90.5 + 1.0 * 9.5) / 100.0


def _hand_sed_scores_single():
    scores = {"f1": {"onset": np.array([0.0, 5.0, 10.0]),
                     "offset": np.array([5.0, 10.0, 15.0]),
                     "fake_event": np.array([0.8, 0.3, 0.9])}}
    value = psds.compute_psds_sed_scores(
        scores, {"f1": [(0.0, 5.0, "fake_event")]}, {"a1": 3600.0},
        {"f1": "a1"}, max_efpr=100.0)
    return value, 99.0 / 100.0


def _hand_sed_scores_cttc():
    scores = {"f1": {"onset": np.array([0.0, 5.0, 10.0]),
                     "offset": np.array([5.0, 10.0, 15.0]),
                     "a": np.array([0.8, 0.3, 0.0]),
                     "b": np.array([0.4, 0.9, 0.0])}}
    gt = {"f1": [(0.0, 5.0, "a"), (10.0, 15.0, "a"), (5.0, 10.0, "b")]}
    common = dict(dtc_threshold=0.7, gtc_threshold=0.7, cttc_threshold=0.3,
                  alpha_ct=0.5, max_efpr=100.0)
    v0 = psds.compute_psds_sed_scores(scores, gt, {"a1": 3600.0},
                                      {"f1": "a1"}, alpha_st=0.0, **common)
    v1 = psds.compute_psds_sed_scores(scores, gt, {"a1": 3600.0},
                                      {"f1": "a1"}, alpha_st=1.0, **common)
    return (v0, v1), (0.75, 0.5)


def _hand_sed_eval():
    gt = _ev([("f1", 1.0, 3.0, "a"), ("f1", 5.0, 6.0, "a"),
              ("f1", 7.0, 8.0, "b")])
    det = _ev([("f1", 1.1, 3.1, "a"), ("f1", 6.5, 6.9, "a"),
               ("f1", 7.15, 8.6, "b")])
    event, segment = sed_metrics.compute_sed_eval(gt, det, t_collar=0.2,
                                                  time_resolution=1.0)
    return ((event["overall"]["f_measure"],
             event["class_wise_average"]["f_measure"],
             segment["overall"]["f_measure"],
             segment["class_wise_average"]["f_measure"]),
            (1.0 / 3.0, 0.25, 0.6, 13.0 / 21.0))


HAND = {"op_single": _hand_op_single, "op_cttc": _hand_op_cttc,
        "sed_scores_single": _hand_sed_scores_single,
        "sed_scores_cttc": _hand_sed_scores_cttc,
        "sed_eval": _hand_sed_eval}


@pytest.mark.parametrize("name", list(HAND))
def test_hand_goldens(name):
    got, expected = HAND[name]()
    np.testing.assert_allclose(got, expected, rtol=1e-9)
