"""The port's offline tools against the JAX package's, on the inputs of
``tests/test_tools.py``: the same files in, the same files (or values)
out; the text towers' outputs within 1e-5.  The phrase-embedding
extraction runs both packages on one local ``BertModel`` checkpoint
(``config.json``, ``pytorch_model.bin`` and a WordPiece vocabulary that
the test writes) with the ``sbert`` encoder, and the CLAP path on its
random tiny tower; the BERTScore / BLEURT mappings run both packages'
towers on the same weights."""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_text_towers import np_tree
from texttoaudiogrounding_tpu.models import pretrained_text as jpt
from texttoaudiogrounding_tpu.tools import clustering as jclustering
from texttoaudiogrounding_tpu.tools import embeddings as jembeddings
from texttoaudiogrounding_tpu.tools import label_tools as jlabel
from texttoaudiogrounding_tpu.tools import map_phrase_to_event as jmap
from texttoaudiogrounding_tpu.tools import pack_waveform as jpack
from texttoaudiogrounding_tpu.tools import phrase_parser as jparser
from texttoaudiogrounding_tpu.tools import score_backends as jscore
from texttoaudiogrounding_tpu_torch.models import pretrained_text as pt
from texttoaudiogrounding_tpu_torch.tools import (
    clustering,
    embeddings,
    label_tools,
    map_phrase_to_event,
    pack_waveform,
    phrase_parser,
    score_backends,
)
from texttoaudiogrounding_tpu_torch.weights import from_jax_variables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(tmp_path, run) -> tuple:
    """``run(module_pair_index, directory)`` for the JAX (0) and the port
    (1) tool in a directory each."""
    out = []
    for i, name in enumerate(("jax", "port")):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        out.append(run(i, d))
    return tuple(out)


def _read(path) -> bytes:
    return open(path, "rb").read()


@pytest.mark.parametrize("caption", [
    "a dog barks while a man speaks", "rain falling followed by thunder",
    "a car revs and then accelerates faster", "dogs bark and thunder roars",
    "music is playing, birds chirp", "a man speaks with a woman as a door "
    "creaks"])
def test_phrase_parser_matches_jax(caption):
    assert phrase_parser.PhraseParser()(caption) == \
        jparser.PhraseParser()(caption)
    items = [{"audiocap_id": 1, "audio_id": "Ya.wav",
              "tokens": caption.capitalize() + "."}]
    assert phrase_parser.extract_phrases(items) == \
        jparser.extract_phrases(items)


def test_locate_phrase_matches_jax():
    for tokens, phrase in (("a dog barks while a man speaks", "a man speaks"),
                           ("dog dog barking dog dog", "dog dog"),
                           ("a dog a cat", "cat")):
        assert phrase_parser.locate_phrase(tokens, phrase) == \
            jparser.locate_phrase(tokens, phrase)


def test_pack_waveform_matches_jax(tmp_path):
    from scipy.io import wavfile

    from texttoaudiogrounding_tpu_torch.data.h5io import read_from_h5
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        data = (rng.normal(size=16000) * 3000).astype(np.int16)
        wavfile.write(wav_dir / f"clip{i}.wav", 16000, data)
    mods = (jpack, pack_waveform)

    def run(i, d):
        mods[i].prepare_wav_csv(str(wav_dir), str(d / "wav.csv"))
        mods[i].pack_waveform(str(d / "wav.csv"), str(d / "waveform.h5"),
                              sample_rate=32000, num_workers=2)
        mods[i].prepare_duration(str(d / "waveform.csv"),
                                 str(d / "dur.csv"))
        return d
    jdir, pdir = _both(tmp_path, run)
    assert _read(jdir / "wav.csv") == _read(pdir / "wav.csv")
    assert _read(jdir / "dur.csv") == _read(pdir / "dur.csv")
    for i in range(3):
        np.testing.assert_array_equal(
            read_from_h5(f"clip{i}.wav", str(pdir / "waveform.h5")),
            read_from_h5(f"clip{i}.wav", str(jdir / "waveform.h5")))


def test_label_tools_match_jax(tmp_path):
    items = [
        {"audio_id": "a", "phrases": [
            {"phrase": "dog", "segments": [[0.0, 9.95]]},
            {"phrase": "cat", "segments": [[1.0, 2.0]]}]},
        {"audio_id": "b", "phrases": [
            {"phrase": "dog", "segments": [[0.0, 1.0]]}]},
    ]
    json.dump(items, open(tmp_path / "l.json", "w"))
    json.dump(items[:1], open(tmp_path / "test.json", "w"))
    with open(tmp_path / "dur.csv", "w") as f:
        f.write("audio_id\tduration\na\t10.0\nb\t10.0\n")
    counts = {"a dog barks": 3, "dog barking": 5, "water runs": 7}
    embs = {"a dog barks": np.array([1.0, 0.0]),
            "dog barking": np.array([0.9, 0.1]),
            "water runs": np.array([0.0, 1.0])}
    json.dump(counts, open(tmp_path / "counts.json", "w"))
    pickle.dump(embs, open(tmp_path / "embs.pkl", "wb"))
    mods = (jlabel, label_tools)
    src = str(tmp_path / "l.json")

    def run(i, d):
        m = mods[i]
        m.concat_label([src] * 2, str(d / "c.json"))
        m.calc_phrase_count(src, str(d / "cnt.json"))
        m.sample_subset_by_frac(str(d / "c.json"), str(d / "s.json"), 0.5)
        m.filter_non_trivial_samples(src, str(d / "f.json"),
                                     str(tmp_path / "dur.csv"))
        m.exclude_overlap_with_test(src, str(tmp_path / "test.json"),
                                    str(d / "e.json"))
        m.calc_phrase_sim_count(str(tmp_path / "counts.json"),
                                str(tmp_path / "embs.pkl"),
                                str(d / "sim.json"), threshold=0.5)
        return d
    jdir, pdir = _both(tmp_path, run)
    for name in ("c", "cnt", "s", "f", "e", "sim"):
        assert _read(jdir / f"{name}.json") == _read(pdir / f"{name}.json")
    assert json.load(open(pdir / "sim.json")) == {
        "a dog barks": 8, "dog barking": 8, "water runs": 7}


def test_clustering_and_mapping_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    phrases = {f"phrase {i}": rng.normal(size=8).astype(np.float32)
               for i in range(20)}
    pickle.dump(phrases, open(tmp_path / "pe.pkl", "wb"))
    labels = {"Dog": rng.normal(size=8).astype(np.float32),
              "Cat": rng.normal(size=8).astype(np.float32)}
    pickle.dump(labels, open(tmp_path / "le.pkl", "wb"))
    mods = ((jclustering, jmap), (clustering, map_phrase_to_event))

    def run(i, d):
        mods[i][0].kmeans(str(tmp_path / "pe.pkl"), str(d / "km"),
                          n_clusters=3)
        mods[i][0].agglomerative(str(tmp_path / "pe.pkl"),
                                 str(d / "agc.json"), n_clusters=3)
        mods[i][1].map_phrases(str(tmp_path / "pe.pkl"),
                               str(tmp_path / "le.pkl"), str(d / "map.json"),
                               topk=2)
        return d
    jdir, pdir = _both(tmp_path, run)
    jfiles = sorted(p.name for p in (jdir / "km").glob("*.json"))
    assert jfiles == sorted(p.name for p in (pdir / "km").glob("*.json"))
    for name in jfiles:
        assert _read(jdir / "km" / name) == _read(pdir / "km" / name)
    for name in ("agc.json", "map.json"):
        assert _read(jdir / name) == _read(pdir / name)


def _w2v(path, vecs: dict) -> None:
    with open(path, "wb") as f:
        f.write(f"{len(vecs)} 4\n".encode())
        for word, vec in vecs.items():
            f.write(word.encode() + b" " + vec.tobytes())


def test_word2vec_matrix_matches_jax(tmp_path):
    from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
    vecs = {"dog": np.full(4, 1, np.float32), "bark": np.full(4, 2, np.float32),
            "meow": np.full(4, 3, np.float32),
            "cat": np.arange(4, dtype=np.float32)}
    _w2v(tmp_path / "w2v.bin", vecs)
    vocab = Vocabulary()
    for w in ("<pad>", "<unk>", "Dog", "barking", "meoww", "qqqq", "cat"):
        vocab.add_word(w)
    vocab.save(tmp_path / "vocab.pkl")
    mods = (jembeddings, embeddings)

    def run(i, d):
        read = mods[i].read_word2vec_binary(str(tmp_path / "w2v.bin"))
        return read, mods[i].build_vocab_embedding_matrix(
            str(tmp_path / "vocab.pkl"), str(tmp_path / "w2v.bin"),
            str(d / "emb.npy"))
    (jread, jmat), (read, mat) = _both(tmp_path, run)
    assert sorted(read) == sorted(jread)
    for word in read:
        np.testing.assert_array_equal(read[word], jread[word])
    np.testing.assert_array_equal(mat, jmat)
    for word in ("running", "barking", "whistling", "dogs", "cities"):
        assert embeddings.lemma_candidates(word) == \
            jembeddings.lemma_candidates(word)
    assert embeddings.edit1_candidates("dgo") == \
        jembeddings.edit1_candidates("dgo")


@pytest.fixture(scope="module")
def bert_checkpoint(tmp_path_factory):
    """A local HF BertModel checkpoint: config.json, pytorch_model.bin and
    the tokenizer's files."""
    os.environ.setdefault("USE_TF", "0")
    from transformers import BertConfig, BertModel, BertTokenizer
    d = tmp_path_factory.mktemp("bert")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog",
             "barking", "cat", "meowing", "water", "running", "man",
             "speaks"]
    (d / "vocab.txt").write_text("\n".join(words) + "\n")
    BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    torch.manual_seed(1)
    BertModel(BertConfig(vocab_size=len(words), hidden_size=32,
                         num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=32)
              ).save_pretrained(str(d), safe_serialization=False)
    return d


def _labels(tmp_path) -> str:
    items = [{"audio_id": "a", "phrases": ["dog barking", "cat meowing",
                                           "water running"]},
             {"audio_id": "b", "phrases": [{"phrase": "a man speaks"}]}]
    json.dump(items, open(tmp_path / "l.json", "w"))
    return str(tmp_path / "l.json")


def test_phrase_embeddings_match_jax(tmp_path, bert_checkpoint):
    labels = _labels(tmp_path)
    ref = (jembeddings.extract_phrase_embeddings(
        [labels], str(tmp_path / "j.pkl"), encoder="sbert",
        checkpoint=str(bert_checkpoint), batch_size=2), pickle.load(
        open(tmp_path / "j.pkl", "rb")))[1]
    got = embeddings.extract_phrase_embeddings(
        [labels], str(tmp_path / "p.pkl"), encoder="sbert",
        checkpoint=str(bert_checkpoint), batch_size=2, device="cpu")
    assert got.keys() == ref.keys() == pickle.load(
        open(tmp_path / "p.pkl", "rb")).keys()
    for phrase in ref:
        np.testing.assert_allclose(got[phrase], ref[phrase], rtol=1e-5,
                                   atol=1e-5)
    clap = embeddings.extract_phrase_embeddings(
        [labels], str(tmp_path / "c.pkl"), encoder="clap", device="cpu")
    assert set(clap) == set(ref)
    norms = np.linalg.norm(np.stack(list(clap.values())), axis=-1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        orig = torch.cuda.is_available
        torch.cuda.is_available = lambda: False
        try:
            embeddings.extract_phrase_embeddings([labels],
                                                 str(tmp_path / "x.pkl"))
        finally:
            torch.cuda.is_available = orig


def test_greedy_bertscore_matches_jax():
    rng = np.random.default_rng(0)
    emb, other = rng.normal(size=(5, 8)), rng.normal(size=(6, 8))
    mask = np.array([False, True, True, True, False])
    omask = np.array([False, True, True, False, True, True])
    assert score_backends.greedy_bertscore(emb, mask, other, omask) == \
        jscore.greedy_bertscore(emb, mask, other, omask)
    empty = np.zeros(5, bool)
    assert score_backends.greedy_bertscore(emb, empty, other, omask) == \
        jscore.greedy_bertscore(emb, empty, other, omask) == (0.0, 0.0, 0.0)


@pytest.fixture(scope="module")
def tower_weights():
    """(JAX params, the port's tower state dict) of one tiny tower."""
    jcfg = jpt.tiny_text_tower_config(vocab_size=512)
    tower = jpt.TextTower(jcfg)
    params = np_tree(jax.eval_shape(lambda: tower.init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32),
        np.ones((1, 4), np.int32))), 21)["params"]
    port = pt.TextTower(pt.tiny_text_tower_config(vocab_size=512),
                        device="cpu")
    return params, from_jax_variables({"params": params}, port)


@pytest.mark.parametrize("backend", ["bertscore", "bleurt"])
def test_phrase_mapping_matches_jax(tmp_path, tower_weights, backend):
    """Both backends over the same tower weights: the same best label for
    every phrase, its score within 1e-5."""
    import pandas as pd
    params, sd = tower_weights
    data = [{"audio_id": "a", "phrases": [
        {"phrase": "a dog barks"}, {"phrase": "water running"},
        {"phrase": "a man speaks loudly"}]}]
    json.dump(data, open(tmp_path / "label.json", "w"))
    json.dump(["dog", "water", "speech"], open(tmp_path / "labels.json", "w"))
    args = (str(tmp_path / "label.json"),)
    if backend == "bertscore":
        fns = ({"encode_fn": jscore.make_tower_encoder(params=params)},
               {"encode_fn": score_backends.make_tower_encoder(
                   state_dict=sd, device="cpu")})
    else:
        fns = ({"score_fn": jscore.make_tower_bleurt(params=params)},
               {"score_fn": score_backends.make_tower_bleurt(
                   state_dict=sd, device="cpu")})
    jscore.prepare_phrase_mapping(*args, str(tmp_path / "j.tsv"),
                                  str(tmp_path / "labels.json"),
                                  backend=backend, **fns[0])
    score_backends.prepare_phrase_mapping(*args, str(tmp_path / "p.tsv"),
                                          str(tmp_path / "labels.json"),
                                          backend=backend, device="cpu",
                                          **fns[1])
    ref = pd.read_csv(tmp_path / "j.tsv", sep="\t")
    got = pd.read_csv(tmp_path / "p.tsv", sep="\t")
    assert list(got.columns) == ["phrase", "index", "sim"]
    assert got["phrase"].tolist() == ref["phrase"].tolist()
    assert got["index"].tolist() == ref["index"].tolist()
    np.testing.assert_allclose(got["sim"], ref["sim"], rtol=1e-5, atol=1e-5)
