"""The port's evaluation entry points, checkpoint loading, resume and
``GroundingPredictor.from_experiment``, against the JAX package.

One short port run (``StrongRunner(device="cpu").train``: 8 clips of 1 s
from ``tests/synthetic.py``, the flagship Cnn8Rnn width, shared and text
width 64, 1 epoch of 1 step) serves every test, and one evaluation of its
``best.pth`` in each package (module fixtures).  Tolerances:

* configs: ``inherit_from`` and overrides give JAX's dict exactly;
* ``eval_inference``: the port's score tracks within 1e-5 of JAX
  ``StrongRunner.eval_inference`` with the port's ``best.pth`` imported
  by ``import_biencoder`` (the f32 ``frame_sim`` tolerance of
  ``tests/test_torch_port_model.py``), the WSTAG tracks of a
  ``MultiTextBiEncoder`` the same against JAX ``WeakPhraseRunner``;
* ``_report_metrics`` of each package on the other's buffers: the same
  numbers within 1e-9;
* ``from_experiment``: the evaluated tracks within 1e-6;
* a served model given new weights by ``load_state_dict``: the outputs of
  a model built with them, bit for bit;
* resume: the optimizer, scheduler and monitor states equal the saved
  ones, the run continues at the saved epoch + 1 and Adam's step count
  runs on; finetune and a reference-format ``.pth`` start at epoch 1;
* the evaluate path on in-memory data runs in a process where ``pandas``,
  ``matplotlib``, ``h5py``, ``yaml`` and ``jax`` cannot be imported, and
  gives the numbers of the same evaluation on the HDF5 files.

The JAX functions run on their NumPy paths (the JAX package's native
library builds in place, which its own tests must not be raced on).
"""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from tests.synthetic import make_grounding_data, make_vocab
from texttoaudiogrounding_tpu import native as jnative
from texttoaudiogrounding_tpu.training.runner_strong import (
    StrongRunner as JStrongRunner,
)
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    WeakPhraseRunner as JWeakPhraseRunner,
)
from texttoaudiogrounding_tpu.training.torch_import import import_biencoder
from texttoaudiogrounding_tpu.training.train_state import TrainState
from texttoaudiogrounding_tpu.utils import config as jconfig
from texttoaudiogrounding_tpu_torch import (
    GroundingPredictor,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.evaluation.tables import read_tsv, table
from texttoaudiogrounding_tpu_torch.training.optim import (
    MetricImprover,
    Optimizer,
)
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    StrongRunner,
)
from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
    WeakPhraseRunner,
)
from texttoaudiogrounding_tpu_torch.utils import config as tconfig
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

_WIDTH = 64
_N_TH = 50
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU models: the suite
    runs in several worker processes on a few cores, where every worker's
    thread pool spinning at once slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_paths():
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "get_lib", lambda: None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval")
    wav_csv, label_json, dur_csv = make_grounding_data(
        root / "data", num_audio=8, duration=1.0, seed=3,
        event_len=(0.15, 0.3))
    vocab_path = root / "data" / "vocab.pkl"
    n_vocab = len(make_vocab(label_json, vocab_path))
    collate = {"type": "TextCollate", "args": {
        "text_key": "phrase", "pad_keys": ["waveform", "label"],
        "pad_buckets": {"waveform": 32000, "label": 26}, "text_bucket": 4,
        "tokenizer": {"type": "DictTokenizer",
                      "args": {"vocabulary": str(vocab_path)}}}}

    def loader(batch_size):
        return {"dataset": {"type": "AudioPhraseDataset",
                            "args": {"waveform": str(wav_csv),
                                     "label": str(label_json),
                                     "time_resolution": 0.04}},
                "collate_fn": collate,
                "dataloader_args": {"batch_size": batch_size}}

    config = {
        "experiment_path": str(root / "exp"), "seed": 1,
        "data": {"train": loader(4), "val": loader(8)},
        "model": {"type": "BiEncoder",
                  "args": {"shared_dim": _WIDTH, "add_proj": True},
                  "audio_encoder": {"type": "Cnn8Rnn",
                                    "args": {"sample_rate": 32000}},
                  "text_encoder": {"type": "EmbeddingAgg",
                                   "args": {"vocab_size": n_vocab,
                                            "embed_dim": _WIDTH}},
                  "match_fn": {"type": "ExpNegL2", "args": {}}},
        "loss": {"type": "FrameBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 2e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "factor": 0.5,
                                  "patience": 0}},
        "trainer": {"epochs": 1, "epoch_length": 1, "early_stop": 10,
                    "save_interval": 1, "max_grad_norm": 1.0},
    }
    exp_dir = StrongRunner(device="cpu").train(config)
    test_cfg = {
        "dataset": {"type": "AudioPhraseEvalDataset",
                    "args": {"waveform": str(wav_csv),
                             "label": str(label_json)}},
        "collate_fn": {**collate, "args": {**collate["args"],
                                           "pad_keys": ["waveform"]}},
        "dataloader_args": {"batch_size": 8},
        "duration": str(dur_csv)}
    eval_cfg = {"resume": "best", "n_thresholds": _N_TH, "window_size": 1,
                "max_efprs": [400, None], "output": "result.txt",
                "data": {"test": test_cfg}}
    return {"root": root, "config": config, "exp_dir": exp_dir,
            "eval": eval_cfg, "label_json": label_json,
            "wav_h5": root / "data" / "waveform.h5"}


class _Recorder:
    """``scores_per_sample``: keeps each raw track (in the order the
    buffers are filled) and hands back the track stretched over [0, 1], so
    that every threshold decodes something on a barely trained model."""

    def __init__(self):
        self.raw = []

    def __call__(self, scores):
        self.raw.append(np.array(scores))
        lo, hi = float(scores.min()), float(scores.max())
        return ((scores - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def _port_eval(run, model_overrides=None, clips=None):
    """The port's evaluation of ``best.pth`` (of the first ``clips`` audio
    items only, where given)."""
    runner = StrongRunner(device="cpu")
    eval_cfg = json.loads(json.dumps(run["eval"]))
    if model_overrides:
        eval_cfg["model_overrides"] = model_overrides
    if clips:
        eval_cfg["data"]["test"]["dataset"]["args"]["label"] = json.loads(
            run["label_json"].read_text())[:clips]
    _, _, model, loader = runner._load_for_eval(run["exp_dir"], eval_cfg)
    rec = _Recorder()
    out = runner.eval_inference(loader, model, rec)
    return runner, out, dict(zip(out["score_buffer"], rec.raw))


@pytest.fixture(scope="module")
def port_eval(run):
    """(runner, output on stretched tracks, raw tracks by filename)."""
    return _port_eval(run)


@pytest.fixture(scope="module")
def jax_eval(run):
    runner = JStrongRunner()
    runner.setup(tconfig.load_config(run["exp_dir"] / "config.json"))
    runner.config["eval_config"] = {"n_thresholds": _N_TH}
    runner.config["inference_args"] = {"window_size": 1}
    model = runner.build_model()
    sd = torch.load(run["exp_dir"] / "best.pth", weights_only=True)["model"]
    v = import_biencoder({k: t.numpy() for k, t in sd.items()})
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=None, step=0)
    loader = runner.build_dataloader(run["eval"]["data"]["test"],
                                     shuffle=False)
    rec = _Recorder()
    out = runner.eval_inference(loader, model, state, rec)
    return runner, out, dict(zip(out["score_buffer"], rec.raw))


@pytest.fixture(scope="module")
def evaluated(run):
    return StrongRunner(device="cpu").evaluate(run["exp_dir"], run["eval"])


# ------------------------------------------------------------- configs

OVERRIDES = {
    "none": ([], {}),
    "dotted": (["trainer.epochs=3", "optimizer.args.lr=1e-4",
                "parallel.mesh.model=4", "seed=7"], {}),
    "kwargs": (["trainer.early_stop=2"],
               {"trainer": {"epochs": 2}, "experiment_path": "x"}),
}


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_config_inherit_and_overrides_match_jax(name, tmp_path):
    overrides, kwargs = OVERRIDES[name]
    path = "configs/strong/biencoder_train_dp4tp2.yaml"
    got = tconfig.parse_config_or_kwargs(path, overrides, **kwargs)
    ref = jconfig.parse_config_or_kwargs(path, overrides, **kwargs)
    assert got == ref
    assert "inherit_from" not in got and got["parallel"]["mesh"]["data"] == 4
    tconfig.dump_config(got, tmp_path / "config.json")
    assert tconfig.load_config(tmp_path / "config.json") == got


# ---------------------------------------------------------- inference

def test_eval_inference_matches_jax(port_eval, jax_eval):
    _, got, got_raw = port_eval
    _, ref, ref_raw = jax_eval
    assert got_raw.keys() == ref_raw.keys() == ref["score_buffer"].keys()
    assert len(got_raw) >= 8
    for fname, scores in ref_raw.items():
        assert got_raw[fname].shape == scores.shape
        np.testing.assert_allclose(got_raw[fname], scores, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["score_buffer"][fname]["onset"],
                                   ref["score_buffer"][fname].onset,
                                   rtol=0, atol=1e-12)
    assert got["gt_dict"] == ref["gt_dict"]
    assert got["fname_to_aid"] == ref["fname_to_aid"]
    assert list(got["pred_buffer"]) == list(ref["pred_buffer"])


def _to_jax(out: dict) -> dict:
    return {"pred_buffer": {th: pd.DataFrame(t)
                            for th, t in out["pred_buffer"].items()},
            "score_buffer": {f: pd.DataFrame(t)
                             for f, t in out["score_buffer"].items()},
            "gt_df": pd.DataFrame(out["gt_table"]),
            "gt_dict": out["gt_dict"], "fname_to_aid": out["fname_to_aid"]}


def _to_port(out: dict) -> dict:
    def tab(df):
        return table({c: df[c].to_numpy() for c in df.columns})
    return {"pred_buffer": {th: tab(df)
                            for th, df in out["pred_buffer"].items()},
            "score_buffer": {f: {c: df[c].to_numpy() for c in df.columns}
                             for f, df in out["score_buffer"].items()},
            "gt_table": tab(out["gt_df"]), "gt_dict": out["gt_dict"],
            "fname_to_aid": out["fname_to_aid"]}


def _every_fifth_threshold(out: dict) -> dict:
    """10 of the 50 operating points: the JAX th-AUC's pandas work grows
    with them."""
    keep = list(out["pred_buffer"])[::5]
    return {**out, "pred_buffer": {th: out["pred_buffer"][th]
                                   for th in keep}}


@pytest.mark.parametrize("source", ["port", "jax"])
def test_report_metrics_on_each_others_buffers(run, port_eval, jax_eval,
                                               source, tmp_path,
                                               monkeypatch):
    if source == "port":
        runner, port_out, _ = port_eval
        port_out = _every_fifth_threshold(port_out)
        jrunner, jax_out = jax_eval[0], _to_jax(port_out)
    else:
        jrunner, jax_out, _ = jax_eval
        jax_out = _every_fifth_threshold(jax_out)
        runner, port_out = port_eval[0], _to_port(jax_out)
    cfg = {**run["eval"], "max_efprs": [None]}
    import matplotlib.pyplot as plt      # the numbers, not the figures
    monkeypatch.setattr(plt, "savefig", lambda *a, **k: None)
    ref = jrunner._report_metrics(jax_out, cfg, tmp_path / "jax")
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # TSVs only
    got = runner._report_metrics(port_out, cfg, tmp_path / "port")
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        assert abs(got[key] - value) <= 1e-9, key
    assert 0.0 < ref["psds@None"] < 1.0 and 0.0 < ref["th_auc@0.0-1.0"]
    for th in (0.01, 0.51, 0.91):
        name = f"predictions/predictions_th_{th:.2f}.tsv"
        mine = read_tsv(tmp_path / "port" / name)
        theirs = pd.read_csv(tmp_path / "jax" / name, sep="\t")
        assert list(mine) == list(theirs.columns)
        np.testing.assert_array_equal(mine["onset"], theirs.onset)


# ------------------------------------------------------ entry points

def test_evaluate_and_random_write_their_results(run, evaluated):
    results = evaluated
    assert set(results) == {"psds@400", "psds@None", "th_auc@0.0-1.0",
                            "th_auc@0.2-0.8"}
    assert all(0.0 <= v <= 1.0 for v in results.values())
    exp = run["exp_dir"]
    assert "psds: " in (exp / "result.txt").read_text()
    assert len(list((exp / "predictions").glob("*.tsv"))) == _N_TH
    assert (exp / "psds" / "PSDS_sedscores_dtc0.5_gtc0.5_maxefprNone.tsv"
            ).is_file()
    assert (exp / "th_auc" / "f_vs_th.tsv").is_file()
    rand = StrongRunner(device="cpu").evaluate_random(run["eval"])
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in rand.values())


ENTRY_POINTS = {
    "evaluate_psds": ("psds_op@dtc=gtc=0.5", {"max_efpr": 1000}),
    "evaluate_th_auc": ("th_auc", {}),
    "evaluate_collar_auc": ("collar_auc", {}),
    "evaluate_intersection_auc": ("intersection_auc", {}),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_other_entry_points_give_finite_metrics(run, name):
    key, extra = ENTRY_POINTS[name]
    result = getattr(StrongRunner(device="cpu"), name)(
        run["exp_dir"], {**run["eval"], **extra})
    assert 0.0 <= result[key] <= 1.0


def test_evaluate_psds_single_restores_the_dataset(run):
    result = StrongRunner(device="cpu").evaluate_psds_single(
        run["exp_dir"], {**run["eval"], "output": "single.tsv"})
    assert len(result["psds"]) == 8
    assert np.isfinite(result["psds"]).all()
    written = read_tsv(run["exp_dir"] / "single.tsv")
    assert list(written["audiocap_id"]) == [str(a) for a in
                                            result["audiocap_id"]]


def test_calc_params_and_debug(run):
    runner = StrongRunner(device="cpu")
    n = runner.calc_params(run["config"])
    model = instantiate(run["config"]["model"], device="cpu")
    # the flax tree's count: the BiGRU's detached r/z recurrent biases
    # (2H a direction) are left out
    assert n == sum(p.numel() for p in model.parameters()) - 2 * 2 * 256
    losses = StrongRunner(device="cpu").debug(run["config"], iters=1)
    assert len(losses) == 1 and np.isfinite(losses).all()


def test_serving_override_evaluates_the_same_weights(run, port_eval):
    runner, _, served = _port_eval(run, {"audio_encoder": {"args": {
        "dtype": "bfloat16", "conv_mode": "int8"}}}, clips=4)
    assert runner.config["model"]["audio_encoder"]["args"]["conv_mode"] \
        == "int8"
    assert len(served) >= 4
    for fname, scores in served.items():
        assert np.abs(scores - port_eval[2][fname]).max() <= 0.05, fname


# ------------------------------------------------- checkpoint loading

def _fresh_states(run):
    runner = StrongRunner(device="cpu")
    runner.setup(run["config"])
    model = runner.build_model()
    opt = Optimizer(run["config"]["optimizer"], model.parameters(), 1.0)
    sched = instantiate(run["config"]["lr_scheduler"])
    return runner, model, opt, sched, MetricImprover("min")


def test_resume_restores_the_states_and_continues(run, tmp_path):
    saved = torch.load(run["exp_dir"] / "last.pth", weights_only=True)
    runner, model, opt, sched, mon = _fresh_states(run)
    meta = runner._resume(model, opt, sched, mon,
                          run["exp_dir"] / "last.pth")
    assert meta == {"epoch": 1, "not_improve_cnt":
                    saved["not_improve_cnt"]}
    for k, v in saved["model"].items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0,
                                   atol=0)
    state = opt.state_dict()
    assert state["param_groups"] == saved["optimizer"]["param_groups"]
    for i, st in saved["optimizer"]["state"].items():
        for key, value in st.items():
            torch.testing.assert_close(state["state"][i][key], value,
                                       rtol=0, atol=0)
    assert sched.state_dict() == saved["lr_scheduler"]
    assert mon.state_dict() == saved["metric_monitor"]

    config = {**run["config"], "experiment_path": str(tmp_path / "r"),
              "resume": str(run["exp_dir"] / "last.pth"),
              "trainer": {**run["config"]["trainer"], "epochs": 2}}
    exp = StrongRunner(device="cpu").train(config)
    log = (exp / "train.log").read_text()
    assert "epoch: 2" in log and "epoch: 1 " not in log
    last = torch.load(exp / "last.pth", weights_only=True)
    assert last["epoch"] == 2
    step = last["optimizer"]["state"][0]["step"]
    assert float(step) == float(saved["optimizer"]["state"][0]["step"]) + 1


@pytest.mark.parametrize("how", ["finetune", "reference_pth"])
def test_finetune_and_reference_checkpoints_start_at_epoch_1(run, how,
                                                             tmp_path):
    saved = torch.load(run["exp_dir"] / "best.pth", weights_only=True)
    config = {**run["config"], "experiment_path": str(tmp_path / "f"),
              "trainer": {**run["config"]["trainer"], "epochs": 1,
                          "epoch_length": 1}}
    if how == "finetune":
        config.update(resume=str(run["exp_dir"] / "best.pth"),
                      finetune=True)
    else:       # the JAX package's save_torch_checkpoint layout
        path = tmp_path / "reference.pth"
        torch.save({"model": saved["model"]}, path)
        config["resume"] = str(path)
    runner, model, opt, sched, mon = _fresh_states(run)
    assert runner._resume(model, opt, sched, mon, config["resume"],
                          finetune=how == "finetune") == {}
    for k, v in saved["model"].items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0,
                                   atol=0)
    assert not opt.state_dict()["state"]
    exp = StrongRunner(device="cpu").train(config)
    last = torch.load(exp / "last.pth", weights_only=True)
    assert last["epoch"] == 1
    assert float(last["optimizer"]["state"][0]["step"]) == 1.0


def test_served_model_takes_new_weights_by_load_state_dict(run):
    """The conv blocks' prepared weights are keyed on the tensors'
    ``(data_ptr, _version)``: ``load_state_dict`` copies in place, which
    must make them anew."""
    cfg = json.loads((run["exp_dir"] / "config.json").read_text())["model"]
    cfg["audio_encoder"]["args"].update(dtype="bfloat16", conv_mode="int8")
    trained = torch.load(run["exp_dir"] / "best.pth",
                         weights_only=True)["model"]
    served = instantiate(cfg, device="cpu").eval()
    batch = {"waveform": torch.from_numpy(
        np.random.default_rng(5).normal(0, 0.1, (2, 16000)).astype(
            np.float32)),
        "waveform_len": torch.tensor([16000, 11000]),
        "text": torch.tensor([[2, 3, 0, 0], [4, 0, 0, 0]]),
        "text_len": torch.tensor([2, 1])}
    with torch.no_grad():
        before = served(batch)["frame_sim"]
        served.load_state_dict(trained)
        after = served(batch)["frame_sim"]
        fresh = instantiate(cfg, device="cpu").eval()
        fresh.load_state_dict(trained)
        ref = fresh(batch)["frame_sim"]
    assert not torch.equal(before, ref)
    torch.testing.assert_close(after, ref, rtol=0, atol=0)


# ------------------------------------------------------ WSTAG, serving

def test_wstag_eval_inference_matches_jax(run):
    config = {"seed": 1, "model": {
        "type": "MultiTextBiEncoder",
        "args": {"shared_dim": 512, "add_proj": False,
                 "pooling": "linear_softmax",
                 "text_forward_keys": ["text", "text_len"]},
        "audio_encoder": {"type": "Cnn8Rnn", "args": {"sample_rate": 32000}},
        "text_encoder": {"type": "EmbeddingAgg",
                         "args": {"vocab_size": 40, "embed_dim": 512}},
        "match_fn": {"type": "DotProduct", "args": {}}}}
    eval_keys = {"eval_config": {"n_thresholds": _N_TH},
                 "inference_args": {"window_size": 1,
                                    "time_resolution": 0.04}}
    runner = WeakPhraseRunner(device="cpu")
    runner.setup(dict(config, **eval_keys))
    model = runner.build_model()
    model.load_state_dict(random_state_dict(model, seed=3))
    variables = import_biencoder({k: v.numpy() for k, v in
                                  model.state_dict().items()})
    jrunner = JWeakPhraseRunner()
    jrunner.setup(dict(config, **eval_keys))
    jmodel = jrunner.build_model()
    test_cfg = run["eval"]["data"]["test"]
    ref = jrunner.eval_inference(
        jrunner.build_dataloader(test_cfg, shuffle=False), jmodel,
        TrainState(params=variables["params"],
                   batch_stats=variables["batch_stats"], opt_state=None,
                   step=0))
    got = runner.eval_inference(
        runner.build_dataloader(test_cfg, shuffle=False), model)
    assert got["score_buffer"].keys() == ref["score_buffer"].keys()
    for fname, df in ref["score_buffer"].items():
        np.testing.assert_allclose(got["score_buffer"][fname]["fake_event"],
                                   df.fake_event, rtol=0, atol=1e-5)


def test_from_experiment_serves_the_evaluated_tracks(run, port_eval):
    raw = port_eval[2]
    pred = GroundingPredictor.from_experiment(run["exp_dir"], device="cpu",
                                              batch_buckets=())
    assert pred.time_resolution == 0.04
    loader = StrongRunner(device="cpu")
    loader.setup(run["exp_dir"] / "config.json")
    dataset = loader.build_dataloader(run["eval"]["data"]["test"],
                                      shuffle=False).dataset
    items = [dataset[i] for i in range(len(dataset))]
    probs, lengths = pred.predict(
        np.stack([it["waveform"].astype(np.float32) for it in items]),
        [len(it["waveform"]) for it in items],
        [it["phrase"] for it in items], return_length=True)
    for it, prob, n in zip(items, probs, lengths):
        scores = raw.get(f"{it['audiocap_id']}_{it['start_index']}")
        if scores is not None:
            np.testing.assert_allclose(prob[:n], scores, rtol=0, atol=1e-6)


# ------------------------------------------------------- no pandas

_CHILD = r"""
import json, sys
for name in ("pandas", "matplotlib", "h5py", "yaml", "jax"):
    sys.modules[name] = None
import numpy as np
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    StrongRunner)
arrays = np.load(sys.argv[2])
cfg = json.loads(open(sys.argv[3]).read())
cfg["data"]["test"]["dataset"]["args"]["waveform"] = {
    k: arrays[k] for k in arrays.files}
results = StrongRunner(device="cpu").evaluate(sys.argv[1], cfg)
for name in ("pandas", "matplotlib", "h5py", "yaml", "jax"):
    assert sys.modules[name] is None, name
print(json.dumps(results))
"""


def test_evaluate_in_memory_without_pandas_yaml_h5py_jax(run, evaluated,
                                                        tmp_path):
    import h5py

    exp = tmp_path / "exp"
    exp.mkdir()
    for name in ("config.json", "best.pth"):
        shutil.copy(run["exp_dir"] / name, exp / name)
    with h5py.File(run["wav_h5"], "r") as hf:
        np.savez(tmp_path / "wave.npz", **{k: hf[k][()] for k in hf})
    cfg = json.loads(json.dumps(run["eval"]))
    args = cfg["data"]["test"]["dataset"]["args"]
    args["label"] = json.loads(run["label_json"].read_text())
    args["waveform"] = None
    (tmp_path / "eval.json").write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(exp), str(tmp_path / "wave.npz"),
         str(tmp_path / "eval.json")], capture_output=True, text=True,
        timeout=300, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got.keys() == set(evaluated)
    for key, value in evaluated.items():
        assert math.isclose(got[key], value, rel_tol=0, abs_tol=1e-12), key
    roc = "PSDS_sedscores_dtc0.5_gtc0.5_maxefprNone"
    assert (exp / "psds" / f"{roc}.tsv").is_file()
    assert not (exp / "psds" / f"{roc}.png").exists()
