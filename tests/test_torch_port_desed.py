"""The port's zero-shot DESED evaluation against the JAX package.

* ``evaluate_desed_psds`` (PSDS1, PSDS2) and ``evaluate_desed_macro_f1``
  (macro-F1 and each class's F1 of the double-threshold decoding) on a
  golden scenario made from a numpy seed (12 clips of 10 s at 0.1 s,
  every DESED class with ground truth, score tracks that partly follow
  it): within 1e-9 of JAX's (the JAX metrics on their NumPy paths, its
  native library's ``get_lib`` patched away: it builds in place and must
  not be raced);
* ``score_clips_zero_shot``: the port's ``GroundingPredictor`` and JAX's
  over the same ``MultiTextBiEncoder`` weights (a CDur audio tower of
  width 32 and the word-embedding text tower; the port's random weights,
  carried to JAX by ``tests/test_torch_port_cdur.py``'s
  ``jax_cdur_variables``) on two 1 s clips against the 10 class phrases:
  every score track within 1e-5, the same frame times;
* ``run_desed_evaluation`` reads an experiment's directory and the
  tab-separated waveform index, ground truth and durations with the
  standard library, keeps the DESED classes of the ground truth, and
  gives the metrics of scoring the same clips directly.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from tests.synthetic import make_grounding_data
from tests.test_torch_port_cdur import jax_cdur_variables
from texttoaudiogrounding_tpu import native as jnative
from texttoaudiogrounding_tpu.data.tokenizer import DictTokenizer as JTok
from texttoaudiogrounding_tpu.data.vocabulary import Vocabulary as JVocab
from texttoaudiogrounding_tpu.evaluation import desed as jdesed
from texttoaudiogrounding_tpu.inference import GroundingPredictor as JPred
from texttoaudiogrounding_tpu.models import CrnnEncoder as JCrnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.audio_text_model import (
    MultiTextBiEncoder as JMultiText,
)
from texttoaudiogrounding_tpu.models.match import DotProduct as JDotProduct
from texttoaudiogrounding_tpu_torch import (
    GroundingPredictor,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
from texttoaudiogrounding_tpu_torch.evaluation import desed
from texttoaudiogrounding_tpu_torch.evaluation.tables import table
from texttoaudiogrounding_tpu_torch.models import (
    CrnnEncoder,
    DotProduct,
    EmbeddingAgg,
    MultiTextBiEncoder,
)
from texttoaudiogrounding_tpu_torch.training.train_state import (
    save_checkpoint,
)
from texttoaudiogrounding_tpu_torch.utils.config import dump_config

TOL = 1e-9
_EMBED = 32
_WORDS = ["<pad>", "<unk>"] + sorted({
    w for p in desed.CLASS_TO_PHRASE.values() for w in p.split()})


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_paths():
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "get_lib", lambda: None)
    yield
    mp.undo()


def _scenario(accurate: bool):
    """(port score tables, JAX score DataFrames, ground truth,
    durations)."""
    rng = np.random.default_rng(17 if accurate else 18)
    t, res = 100, 0.1
    classes = desed.DESED_CLASSES
    tables, frames, ground_truth, durations = {}, {}, {}, {}
    for i in range(12):
        aid = f"clip{i}"
        events = []
        tracks = {c: rng.uniform(0.0, 0.3, t) for c in classes}
        for j in range(1 + i % 3):
            cls = classes[(i + 4 * j) % len(classes)]
            on = int(rng.integers(0, 70))
            off = on + int(rng.integers(5, 30))
            events.append((on * res, off * res, cls))
            if accurate or j == 0:
                tracks[cls][on:off] = rng.uniform(0.5, 1.0, off - on)
        ground_truth[aid] = events
        durations[aid] = t * res
        stamps = np.arange(t + 1) * res
        cols = {"onset": stamps[:-1], "offset": stamps[1:], **tracks}
        tables[aid] = table(cols)
        frames[aid] = pd.DataFrame(cols)
    return tables, frames, ground_truth, durations


@pytest.mark.parametrize("accurate", [True, False])
def test_desed_metrics_match_jax(accurate):
    tables, frames, gt, durations = _scenario(accurate)
    ref = jdesed.evaluate_desed_psds(frames, gt, durations)
    got = desed.evaluate_desed_psds(tables, gt, durations)
    for key in ("psds1", "psds2"):
        assert 0.0 < got[key] <= 1.0
        assert abs(got[key] - ref[key]) <= TOL, key
    ref_f1 = jdesed.evaluate_desed_macro_f1(frames, gt, durations,
                                            time_resolution=0.1)
    got_f1 = desed.evaluate_desed_macro_f1(tables, gt, durations,
                                           time_resolution=0.1)
    assert 0.0 < got_f1["macro_f1"] <= 1.0
    assert abs(got_f1["macro_f1"] - ref_f1["macro_f1"]) <= TOL
    assert got_f1["class_f1"].keys() == ref_f1["class_f1"].keys()
    for cls, value in ref_f1["class_f1"].items():
        assert abs(got_f1["class_f1"][cls] - value) <= TOL, cls
    pred = ref_f1["predictions"]
    assert len(got_f1["predictions"]["onset"]) == len(pred)
    np.testing.assert_allclose(np.sort(got_f1["predictions"]["onset"]),
                               np.sort(pred["onset"].to_numpy()), atol=TOL)


def _port_model():
    return MultiTextBiEncoder(
        CrnnEncoder(embed_dim=_EMBED), EmbeddingAgg(len(_WORDS), _EMBED),
        DotProduct(), shared_dim=_EMBED, pooling="linear_softmax",
        device="cpu")


def _clips(seed: int, n: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {f"c{i}": (rng.normal(size=32000) * 0.1).astype(np.float32)
            for i in range(n)}


def test_zero_shot_scores_match_the_jax_predictor():
    model = _port_model()
    sd = random_state_dict(model, seed=8)
    model.load_state_dict(sd)
    jmodel = JMultiText(
        audio_encoder=JCrnn(sample_rate=32000, embed_dim=_EMBED),
        text_encoder=JEmbeddingAgg(vocab_size=len(_WORDS), embed_dim=_EMBED),
        match_fn=JDotProduct(), shared_dim=_EMBED, pooling="linear_softmax")
    jvars = jax_cdur_variables({k: v.numpy() for k, v in sd.items()})
    jv, tv = JVocab(), Vocabulary()
    for w in _WORDS:
        jv.add_word(w)
        tv.add_word(w)
    clips = _clips(3)
    ref = jdesed.score_clips_zero_shot(
        JPred(jmodel, jvars, JTok(jv), time_resolution=0.08), clips, 0.08)
    pred = GroundingPredictor(model, DictTokenizer(tv), time_resolution=0.08)
    got = desed.score_clips_zero_shot(pred, clips, 0.08)
    assert got.keys() == ref.keys() == clips.keys()
    for aid, frame in ref.items():
        assert len(got[aid]["onset"]) == len(frame) == 12
        np.testing.assert_allclose(got[aid]["offset"],
                                   frame["offset"].to_numpy(), atol=1e-12)
        for cls in desed.DESED_CLASSES:
            np.testing.assert_allclose(got[aid][cls], frame[cls].to_numpy(),
                                       rtol=0, atol=1e-5, err_msg=cls)


def test_run_desed_evaluation_reads_the_files(tmp_path):
    wav_csv, _, _ = make_grounding_data(tmp_path / "data", num_audio=3,
                                        duration=1.0, seed=9)
    aids = [line.split("\t")[0]
            for line in wav_csv.read_text().splitlines()[1:]]
    gt_tsv = tmp_path / "validation.tsv"
    rows = [(aids[0], 0.1, 0.5, "Dog"), (aids[1], 0.2, 0.9, "Speech"),
            (aids[2], 0.0, 0.4, "Cat"), (aids[2], 0.5, 0.8, "Not_desed")]
    gt_tsv.write_text("filename\tonset\toffset\tevent_label\n" + "".join(
        f"{a}\t{on}\t{off}\t{c}\n" for a, on, off, c in rows))
    dur_tsv = tmp_path / "duration.tsv"
    dur_tsv.write_text("filename\tduration\n" + "".join(
        f"{a}\t1.0\n" for a in aids))
    vocab = Vocabulary()
    for w in _WORDS:
        vocab.add_word(w)
    vocab.save(tmp_path / "vocab.pkl")
    model = _port_model()
    model.load_state_dict(random_state_dict(model, seed=2))
    exp = tmp_path / "exp"
    exp.mkdir()
    dump_config({"model": {
        "type": "MultiTextBiEncoder",
        "args": {"shared_dim": _EMBED, "pooling": "linear_softmax"},
        "audio_encoder": {"type": "CrnnEncoder",
                          "args": {"embed_dim": _EMBED}},
        "text_encoder": {"type": "EmbeddingAgg",
                         "args": {"vocab_size": len(_WORDS),
                                  "embed_dim": _EMBED}},
        "match_fn": {"type": "DotProduct", "args": {}}},
        "data": {"train": {
            "dataset": {"type": "AudioSamplePhrasesDataset", "args": {}},
            "collate_fn": {"type": "TextCollate", "args": {
                "tokenizer": {"type": "DictTokenizer", "args": {
                    "vocabulary": str(tmp_path / "vocab.pkl")}}}}}}},
        exp / "config.json")
    save_checkpoint(exp / "best.pth", model, None, None, 1, {}, 0,
                    include_optim=False)
    results = desed.run_desed_evaluation(exp, wav_csv, gt_tsv, dur_tsv,
                                         time_resolution=0.08, device="cpu")

    pred = GroundingPredictor.from_experiment(exp, device="cpu")
    import h5py
    h5_path = wav_csv.read_text().splitlines()[1].split("\t")[1]
    with h5py.File(h5_path, "r") as hf:
        clips = {a: hf[a][()] for a in aids}
    scores = desed.score_clips_zero_shot(pred, clips, 0.08)
    gt = {a: [(on, off, c) for b, on, off, c in rows
              if b == a and c in desed.DESED_CLASSES] for a in aids}
    durations = dict.fromkeys(aids, 1.0)
    want = {**desed.evaluate_desed_psds(scores, gt, durations),
            "macro_f1": desed.evaluate_desed_macro_f1(
                scores, gt, durations, time_resolution=0.08)["macro_f1"]}
    for key, value in want.items():
        assert results[key] == pytest.approx(value, abs=1e-12), key
        assert 0.0 <= results[key] <= 1.0
    assert torch.equal(pred.model.audio_encoder.block1.conv.weight,
                       model.audio_encoder.block1.conv.weight)
