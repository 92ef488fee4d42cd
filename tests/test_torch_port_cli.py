"""The port's command line, single-clip inference and deployment
directories against the JAX package.

* The CLI: every runner name and command of JAX ``cli.py`` reaches the
  same runner method with the same arguments in both packages (spies on
  the methods; nothing is trained), a ``key=value`` in the command slot
  is an override, the ``SystemExit`` texts are JAX's, and
  ``calc_params_macs`` exits with the port's message;
* ``calc_params``: the port's count equals the flax tree's (``jax.
  eval_shape`` of ``model.init``) on three shipped configs;
* ``run_inference``: the segments equal JAX's on the same weights and WAV
  (a JAX run made by ``save_checkpoint`` as ``tests/test_hf_export.py``
  makes it, and a port run with the same weights through
  ``from_jax_variables``), also through ``python -m``'s ``__main__``;
* deployment: a JAX-exported directory serves in the port within 1e-4
  relative RMS of JAX's ``predictor_from_deployment``; the port's export
  → load round trip is bit for bit; the port's ``model.pth`` equals JAX's
  key for key and value for value, its artifact ``config.json`` equals
  JAX's, and ``AutoModel.from_pretrained(..., trust_remote_code=True)``
  on it matches the port's predictor within ``test_hf_export.py``'s 2e-3.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from tests.synthetic import make_grounding_data, make_vocab
from tests.test_torch_port_align import jax_variables
from tests.test_torch_port_train import _rel_rms
from texttoaudiogrounding_tpu import cli as jcli
from texttoaudiogrounding_tpu import deployment as jdeployment
from texttoaudiogrounding_tpu import inference as jinference
from texttoaudiogrounding_tpu.training import runner_class_mapping as jrcm
from texttoaudiogrounding_tpu.training import runner_strong as jrs
from texttoaudiogrounding_tpu.training import runner_weak_phrase as jrwp
from texttoaudiogrounding_tpu.training import runner_weak_sentence as jrws
from texttoaudiogrounding_tpu.training.train_state import (
    TrainState,
    save_checkpoint,
)
from texttoaudiogrounding_tpu.utils import registry as jregistry
from texttoaudiogrounding_tpu_torch import cli, deployment, inference
from texttoaudiogrounding_tpu_torch.models.layers import BiGRU
from texttoaudiogrounding_tpu_torch.training import (
    runner_class_mapping,
    runner_strong,
    runner_weak_phrase,
    runner_weak_sentence,
)
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    CALC_PARAMS_MACS_MESSAGE,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

REPO = Path(__file__).resolve().parents[1]

# runner name → (JAX class, port class)
_RUNNERS = {
    "strong": (jrs.StrongRunner, runner_strong.StrongRunner),
    "weak_phrase": (jrwp.WeakPhraseRunner,
                    runner_weak_phrase.WeakPhraseRunner),
    "weak_phrase_selfsup": (
        jrwp.WeakPhraseSelfSupervisionRunner,
        runner_weak_phrase.WeakPhraseSelfSupervisionRunner),
    "weak_sentence": (jrws.WeakSentenceRunner,
                      runner_weak_sentence.WeakSentenceRunner),
    "class_mapping_strong": (jrcm.ClassMappingStrongRunner,
                             runner_class_mapping.ClassMappingStrongRunner),
    "class_mapping_weak": (jrcm.ClassMappingWeakRunner,
                           runner_class_mapping.ClassMappingWeakRunner),
}
_METHODS = ("train", "evaluate", "train_evaluate", "evaluate_psds",
            "evaluate_th_auc", "evaluate_collar_auc",
            "evaluate_intersection_auc", "evaluate_psds_single",
            "evaluate_tagging", "evaluate_random", "debug", "calc_params",
            "calc_params_macs")
_ARGS = ["--config", "c.yaml", "--eval_config", "e.yaml",
         "--experiment_path", "exp", "a.b=1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU models: the suite
    runs in several worker processes on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, cls, calls: list) -> None:
    for name in _METHODS:
        if hasattr(cls, name):
            monkeypatch.setattr(cls, name, (
                lambda n: lambda self, *a: calls.append((n, a)) or n)(name))


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("runner", list(_RUNNERS))
def test_every_command_reaches_the_jax_method(runner, monkeypatch):
    jcls, tcls = _RUNNERS[runner]
    jcalls, tcalls = [], []
    _spy(monkeypatch, jcls, jcalls)
    _spy(monkeypatch, tcls, tcalls)
    devices = []
    init = tcls.__init__
    monkeypatch.setattr(tcls, "__init__", lambda self, device="cuda": (
        devices.append(device), init(self, device="cpu"))[-1])
    commands = [None, "train", "evaluate", "train_evaluate",
                "evaluate_psds", "evaluate_th_auc", "evaluate_collar_auc",
                "evaluate_intersection_auc", "evaluate_psds_single",
                "evaluate_random", "debug", "calc_params",
                "calc_params_macs"]
    if runner == "class_mapping_weak":
        commands.append("evaluate_tagging")
    for command in commands:
        argv = [runner] + ([command] if command else []) + _ARGS
        assert cli.main(argv + ["--device", "cpu"]) == jcli.main(argv)
    assert tcalls == jcalls and len(tcalls) == len(commands)
    assert tcalls[0] == ("train", ("c.yaml", ["a.b=1"]))
    assert set(devices) == {"cpu"}
    # a key=value in the command slot is an override of ``train``
    jcalls.clear()
    tcalls.clear()
    argv = [runner, "seed=3", "--config", "c.yaml", "x.y=z"]
    cli.main(argv + ["--device", "cpu"])
    jcli.main(argv)
    assert tcalls == jcalls == [("train", ("c.yaml", ["seed=3", "x.y=z"]))]


def test_commands_of_their_own_reach_their_functions(monkeypatch, tmp_path):
    seen = {}
    for mod, name in ((inference, "run_inference"),
                      (deployment, "export_deployment")):
        monkeypatch.setattr(mod, name, (lambda n: lambda *a, **k: (
            seen.__setitem__(n, (a, k)) or n))(name))
    from texttoaudiogrounding_tpu_torch.evaluation import desed
    monkeypatch.setattr(desed, "run_desed_evaluation", lambda *a, **k: (
        seen.__setitem__("desed", (a, k)) or "desed"))
    assert cli.main(["inference", "--experiment_path", "e", "--audio",
                     "a.wav", "--phrase", "dog", "--device", "cpu"]) \
        == "run_inference"
    assert seen["run_inference"] == ((), {
        "experiment_path": "e", "audio": "a.wav", "phrase": "dog",
        "output": None, "device": "cpu"})
    cli.main(["export", "last", "--experiment_path", "e", "--output", "o",
              "--device", "cpu"])
    assert seen["export_deployment"] == (("e", "o"), {"which": "last",
                                                      "device": "cpu"})
    with pytest.raises(SystemExit):
        cli.main(["export", "--experiment_path", "e"])
    cli.main(["evaluate_desed", "--experiment_path", "e", "wav=w.tsv",
              "gt=g.tsv", "duration=d.tsv", "--device", "cpu"])
    assert seen["desed"] == (("e", "w.tsv", "g.tsv", "d.tsv"), {
        "time_resolution": 0.04, "device": "cpu"})
    rows = "filename\tonset\toffset\tevent_label\n" \
           "a.wav\t0.5\t2.0\tdog\nb.wav\t1.0\t3.0\tcat\n"
    (tmp_path / "ref.tsv").write_text(rows)
    (tmp_path / "est.tsv").write_text(rows.replace("0.5", "0.6"))
    kw = [f"reference={tmp_path / 'ref.tsv'}",
          f"prediction={tmp_path / 'est.tsv'}"]
    event, segment = cli.main(["evaluate_sed_eval"] + kw)
    jevent, jsegment = jcli.main(["evaluate_sed_eval"] + kw)
    for mine, theirs in ((event, jevent), (segment, jsegment)):
        assert mine["overall"]["f_measure"] == pytest.approx(
            theirs["overall"]["f_measure"], abs=1e-12)
        assert mine["class_wise_average"]["f_measure"] == pytest.approx(
            theirs["class_wise_average"]["f_measure"], abs=1e-12)
    assert event["overall"]["f_measure"] == 1.0


@pytest.mark.parametrize("argv", [["nonsense"], ["strong", "nonsense"],
                                  ["inferences", "train"]])
def test_system_exit_texts_are_jax_s(argv, monkeypatch):
    monkeypatch.setattr(runner_strong.StrongRunner, "__init__",
                        lambda self, device="cuda": None)
    monkeypatch.setattr(jrs.StrongRunner, "__init__", lambda self: None)
    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv)
    with pytest.raises(SystemExit) as mine:
        cli.main(argv + ["--device", "cpu"])
    assert str(mine.value) == str(theirs.value)
    assert "unknown" in str(mine.value)


def test_calc_params_macs_exits_with_its_message(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["strong", "calc_params_macs", "--config",
                  str(REPO / "configs/strong/biencoder_train.yaml"),
                  "--device", "cpu"])
    assert str(exc.value) == CALC_PARAMS_MACS_MESSAGE
    assert "cost_analysis" in CALC_PARAMS_MACS_MESSAGE


@pytest.mark.parametrize("config", ["strong/biencoder_train.yaml",
                                    "strong/cdur_w2vmean.yaml",
                                    "class_mapping/kmeans_weak.yaml"])
def test_calc_params_counts_the_flax_tree(config, capsys):
    path = REPO / "configs" / config
    cfg = yaml.safe_load(path.read_text())
    model = jregistry.instantiate(cfg["model"])
    batch = {"waveform": np.zeros((1, 32000), np.float32),
             "waveform_len": np.array([32000], np.int32),
             "text": np.zeros((1, 5), np.int32),
             "text_len": np.array([5], np.int32)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    got = cli.main(["strong", "calc_params", "--config", str(path),
                    "--device", "cpu"])
    assert got == want
    assert capsys.readouterr().out.strip().endswith(f"params: {want}")
    port = instantiate(cfg["model"], device="cpu")
    # each GRU direction's detached r/z recurrent biases: 2H
    assert sum(p.numel() for p in port.parameters()) - want == sum(
        2 * 2 * m.hidden for m in port.modules() if isinstance(m, BiGRU))


# ------------------------------------------------- inference, deployment
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One set of weights as a JAX run (``config.yaml``, an orbax ``best``)
    and a port run (``config.json``, ``best.pth``) of a BiEncoder(Cnn8Rnn,
    EmbeddingAgg(attention), DotProduct) on 1 s synthetic clips, and a
    1.3 s WAV file."""
    root = tmp_path_factory.mktemp("cli_runs")
    wav_csv, label_json, _ = make_grounding_data(root / "data",
                                                 num_audio=3, duration=1.0)
    vocab = make_vocab(label_json, root / "data" / "vocab.pkl")
    config = {
        "data": {"train": {
            "dataset": {"type": "AudioPhraseDataset",
                        "args": {"waveform": str(wav_csv),
                                 "label": str(label_json),
                                 "time_resolution": 0.04}},
            "collate_fn": {"type": "TextCollate", "args": {
                "text_key": "phrase", "pad_keys": ["waveform"],
                "tokenizer": {"type": "DictTokenizer",
                              "args": {"vocabulary": str(
                                  root / "data" / "vocab.pkl")}}}}}},
        "model": {
            "type": "BiEncoder",
            "args": {"shared_dim": 32, "add_proj": True},
            "audio_encoder": {"type": "Cnn8Rnn",
                              "args": {"sample_rate": 32000}},
            "text_encoder": {"type": "EmbeddingAgg",
                             "args": {"vocab_size": len(vocab),
                                      "embed_dim": 32,
                                      "aggregation": "attention"}},
            "match_fn": {"type": "DotProduct", "args": {}}},
    }
    jax_dir, port_dir = root / "jax", root / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    (jax_dir / "config.yaml").write_text(yaml.safe_dump(config))
    (port_dir / "config.json").write_text(json.dumps(config))
    jmodel = jregistry.instantiate(config["model"])
    batch = {"waveform": np.zeros((1, 32000), np.float32),
             "waveform_len": np.array([32000]),
             "text": np.zeros((1, 4), np.int32), "text_len": np.array([4])}
    port_model = instantiate(config["model"], device="cpu")
    variables = jax_variables(jmodel, batch, port_model, seed=7)
    save_checkpoint(jax_dir / "best", TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=None, step=0), 1, {}, 0, include_optim=False)
    torch.save({"model": port_model.state_dict()}, port_dir / "best.pth")
    rng = np.random.default_rng(5)
    wave = rng.normal(0, 0.05, 41600).astype(np.float32)
    t = np.arange(12000, 30000)
    wave[t] += 0.3 * np.sin(2 * np.pi * 800.0 * t / 32000)
    wavfile.write(root / "clip.wav", 32000,
                  (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    return {"root": root, "jax": jax_dir, "port": port_dir,
            "wav": root / "clip.wav", "config": config}


def test_run_inference_matches_jax(runs, tmp_path, capsys, monkeypatch):
    ref = jinference.run_inference(str(runs["jax"]), str(runs["wav"]),
                                   "dog barking", threshold=0.3)
    got = inference.run_inference(runs["port"], str(runs["wav"]),
                                  "dog barking", threshold=0.3,
                                  device="cpu")
    assert got == ref and len(got) >= 1
    plot = tmp_path / "plot" / "prob.png"
    printed = cli.main(["inference", "--experiment_path", str(runs["port"]),
                        "--audio", str(runs["wav"]), "--phrase",
                        "dog barking", "--output", str(plot), "--device",
                        "cpu"])
    assert plot.is_file()
    assert printed == inference.run_inference(
        runs["port"], str(runs["wav"]), "dog barking", device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    inference.run_inference(runs["port"], str(runs["wav"]), "dog barking",
                            output=str(tmp_path / "none.png"), device="cpu")
    assert "not written" in capsys.readouterr().out
    assert not (tmp_path / "none.png").exists()


def test_python_m_runs_inference(runs, capsys, monkeypatch):
    """``python -m texttoaudiogrounding_tpu_torch`` (its ``__main__``, run
    in this process) prints the segments ``run_inference`` returns."""
    import runpy

    monkeypatch.setattr(sys, "argv", [
        "texttoaudiogrounding_tpu_torch", "inference", "--experiment_path",
        str(runs["port"]), "--audio", str(runs["wav"]), "--phrase",
        "dog barking", "--device", "cpu"])
    runpy.run_module("texttoaudiogrounding_tpu_torch", run_name="__main__")
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    want = inference.run_inference(runs["port"], str(runs["wav"]),
                                   "dog barking", device="cpu")
    assert printed == str(want)


def _request():
    rng = np.random.default_rng(9)
    audio = (rng.normal(size=(3, 32000)) * 0.1).astype(np.float32)
    return audio, np.array([32000, 32000, 24000]), [
        "dog barking", "a man speaking", "water splashing loudly"]


@pytest.fixture(scope="module")
def exports(runs, tmp_path_factory):
    """The JAX run exported by JAX, the port run by the port."""
    root = tmp_path_factory.mktemp("deploy")
    jdir = jdeployment.export_deployment(str(runs["jax"]), str(root / "jax"))
    tdir = deployment.export_deployment(runs["port"], root / "port",
                                        device="cpu")
    return jdir, tdir


def test_jax_export_serves_in_the_port(exports):
    jdir, _ = exports
    audio, lens, text = _request()
    ref = jdeployment.predictor_from_deployment(str(jdir)).predict(
        audio, lens, text)
    pred = deployment.predictor_from_deployment(jdir, device="cpu")
    got = pred.predict(audio, lens, text)
    assert got.shape == ref.shape
    assert _rel_rms(got, ref) <= 1e-4
    model, _, deploy = deployment.load_deployment(jdir, device="cpu")
    assert model.device.type == "cpu" and deploy["hf_artifact"]


def test_port_export_round_trip_and_files(runs, exports):
    jdir, tdir = exports
    audio, lens, text = _request()
    ref = inference.GroundingPredictor.from_experiment(
        runs["port"], device="cpu").predict(audio, lens, text)
    got = deployment.predictor_from_deployment(tdir, device="cpu").predict(
        audio, lens, text)
    np.testing.assert_array_equal(got, ref)
    mine = json.loads((tdir / "deploy.json").read_text())
    theirs = json.loads((jdir / "deploy.json").read_text())
    assert list(mine) == list(theirs)
    for key in ("torch_checkpoint", "hf_artifact", "time_resolution",
                "audio_bucket", "text_bucket", "batch_buckets",
                "sample_rate", "tokenizer", "model"):
        assert mine[key] == theirs[key], key
    assert (tdir / "vocabulary.pkl").read_bytes() == (
        jdir / "vocabulary.pkl").read_bytes()
    assert not (tdir / "weights.npz").exists()
    sd = torch.load(tdir / "model.pth", weights_only=True)["model"]
    jsd = torch.load(jdir / "model.pth", weights_only=True)["model"]
    assert list(sd) == list(jsd)
    for key, value in jsd.items():
        assert sd[key].dtype == value.dtype, key
        assert torch.equal(sd[key], value), key
    assert json.loads((tdir / "config.json").read_text()) == json.loads(
        (jdir / "config.json").read_text())
    assert (tdir / "modeling_grounding.py").read_bytes() == (
        REPO / "texttoaudiogrounding_tpu_torch/hf_artifact/"
        "modeling_grounding.py").read_bytes()
    out = deployment.main([str(runs["port"]), str(tdir.parent / "again"),
                           "--device", "cpu"])
    assert (out / "deploy.json").read_text() == (tdir / "deploy.json"
                                                 ).read_text()


def test_automodel_matches_the_port_predictor(runs, exports, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")       # transformers without TensorFlow
    from transformers import AutoModel

    _, tdir = exports
    hf_model = AutoModel.from_pretrained(str(tdir), trust_remote_code=True)
    hf_model.eval()
    audio, _, text = _request()
    lens = np.array([32000, 32000, 32000])
    ref = deployment.predictor_from_deployment(tdir, device="cpu").predict(
        audio, lens, text)
    with torch.no_grad():
        got = hf_model(torch.from_numpy(audio), lens, text).numpy()
    t = min(ref.shape[1], got.shape[1])
    np.testing.assert_allclose(got[:, :t], ref[:, :t], atol=2e-3)


def test_new_entry_points_default_to_the_card(runs, exports, monkeypatch):
    """Without a card, the CLI, ``run_inference``, ``export_deployment`` and
    ``predictor_from_deployment`` raise unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tdir = exports
    calls = [
        lambda: cli.main(["inference", "--experiment_path",
                          str(runs["port"]), "--audio", str(runs["wav"]),
                          "--phrase", "dog"]),
        lambda: inference.run_inference(runs["port"], str(runs["wav"]),
                                        "dog"),
        lambda: deployment.export_deployment(runs["port"],
                                             tdir.parent / "nocard"),
        lambda: deployment.predictor_from_deployment(tdir),
        lambda: cli.main(["strong", "calc_params", "--config", "c.yaml"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
