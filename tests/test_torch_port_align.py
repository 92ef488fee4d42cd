"""The port's sentence-level WSTAG pieces against the JAX package: align
functions, sim poolings, the phrase packing, ``VarNumTextCollate``, the
caption datasets and the three align models.

Same numpy inputs made from a seed; the models' weights are the port's
``random_state_dict`` carried to JAX by ``import_biencoder``, the cross
encoder's drawn with numpy over JAX's parameter shapes
(``jax.eval_shape`` of the init: no JAX initializer runs), and all of them
back through ``from_jax_variables``, loaded strictly.  Tolerances:

* ``AlignDotProduct`` (each ``l2norm`` / ``scaled``), ``AlignExpNegL2``,
  the 12 sim-pooling names and ``pack_phrases``: rtol 1e-6, atol 1e-7
  (the same f32 operations);
* ``VarNumTextCollate`` and the six caption datasets: the same keys,
  values and dtypes as the JAX classes' (the random crop of
  ``AudioCaptionDataset`` at the same seed and ``reseed`` salt);
* ``AudioTextAlignByWord``, ``AudioTextAlignByPhrase`` and
  ``AudioTextCrossAlignByPhrase`` (``CrossAttentionGating(512)`` and a
  token-level ``DotProduct``) at the full Cnn8Rnn width on 1 s clips,
  batch 2: ``sim`` and ``sim_matrix`` within 1e-4 relative RMS, as
  ``tests/test_torch_port_weak.py`` holds ``MultiTextBiEncoder``.  The
  JAX forwards are jitted with the weights and the batch as arguments,
  the Cnn8Rnn tower once for every model (``jax_forward``).
"""

import json

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from tests.synthetic import make_grounding_data
from tests.test_torch_port_train import _rel_rms
from texttoaudiogrounding_tpu.data import collate as jcollate
from texttoaudiogrounding_tpu.data import datasets as jdatasets
from texttoaudiogrounding_tpu.data.tokenizer import DictTokenizer as JTok
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import align as jalign
from texttoaudiogrounding_tpu.models import align_models as jalign_models
from texttoaudiogrounding_tpu.training.torch_import import import_biencoder
from texttoaudiogrounding_tpu.utils import registry as jregistry
from texttoaudiogrounding_tpu_torch import (
    from_jax_variables,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.data import collate, datasets
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
from texttoaudiogrounding_tpu_torch.models import align
from texttoaudiogrounding_tpu_torch.models.align_models import pack_phrases
from texttoaudiogrounding_tpu_torch.models.sim_pooling import (
    MULTI_TEXT_POOLINGS,
    SIM_POOLINGS,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

_VOCAB = 60
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU models: the suite
    runs in several worker processes on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- weights
def _extra_leaf(path: str, shape: tuple, rng) -> np.ndarray:
    """A weight the port's ``random_state_dict`` does not carry to JAX
    (cross encoder, attention): flax's scales, drawn with numpy."""
    if path.endswith("/v"):
        return rng.normal(0.0, 1.0, shape).astype(np.float32)
    if path.endswith("scale"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if path.endswith("bias"):
        return rng.normal(0.0, 0.05, shape).astype(np.float32)
    return rng.normal(0.0, 1.0 / np.sqrt(shape[0]), shape).astype(np.float32)


def jax_variables(jmodel, jbatch: dict, port_model, seed: int) -> dict:
    """JAX variables for ``jmodel`` from the port's random weights (and
    numpy draws for what ``import_biencoder`` does not carry), loaded into
    ``port_model`` strictly through ``from_jax_variables``."""
    base = import_biencoder({k: v.numpy() for k, v in random_state_dict(
        port_model, seed=seed).items()})
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jbatch, train=False))
    rng = np.random.default_rng(seed + 100)

    def fill(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        node = base
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                return _extra_leaf("/".join(keys), leaf.shape, rng)
            node = node[k]
        assert node.shape == leaf.shape, keys
        return np.asarray(node, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    port_model.load_state_dict(from_jax_variables(variables,   # strict
                                                  port_model))
    return variables


_TRUNK = JCnn8Rnn(sample_rate=32000)


@jax.jit
def _jax_trunk(params: dict, stats: dict, waves: dict) -> dict:
    return _TRUNK.apply({"params": params, "batch_stats": stats}, waves,
                        train=False)


def jax_forward(jmodel, variables: dict, batch: dict, **flags) -> dict:
    """``jmodel``'s eval-mode forward on ``batch`` (``flags`` such as
    ``output_matrix`` added to it): its Cnn8Rnn tower run by one jitted
    function that every model of a process shares, the rest jitted per
    model over the tower's output (``flax.linen.intercept_methods``)."""
    trunk = _jax_trunk(variables["params"]["audio_encoder"],
                       variables["batch_stats"]["audio_encoder"],
                       {k: batch[k] for k in ("waveform", "waveform_len")})

    def take(f, args, kwargs, ctx):
        if ctx.method_name == "__call__" and \
                ctx.module.name == "audio_encoder":
            return out
        return f(*args, **kwargs)

    def head(v, b, t):
        nonlocal out
        out = t
        with fnn.intercept_methods(take):
            return jmodel.apply(v, {**b, **flags}, train=False)

    out = None
    return jax.jit(head)(variables, batch, trunk)


# ---------------------------------------------------------- functions
_ALIGNS = {"dp": {}, "dp_l2norm": {"l2norm": True},
           "dp_scaled": {"scaled": True},
           "dp_l2norm_scaled": {"l2norm": True, "scaled": True},
           "expnegl2": None}


@pytest.mark.parametrize("name", list(_ALIGNS))
def test_align_function_matches_jax(name):
    rng = np.random.default_rng(1)
    audio = rng.normal(size=(3, 7, 8)).astype(np.float32)
    text = rng.normal(size=(3, 4, 8)).astype(np.float32)
    args = _ALIGNS[name]
    if args is None:
        jfn, fn = jalign.AlignExpNegL2(), align.AlignExpNegL2()
    else:
        jfn, fn = jalign.AlignDotProduct(**args), align.AlignDotProduct(**args)
    ref = np.asarray(jfn(audio, text))
    got = fn(torch.from_numpy(audio), torch.from_numpy(text)).numpy()
    assert got.shape == ref.shape == (3, 3, 7, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(SIM_POOLINGS)
                         + sorted(MULTI_TEXT_POOLINGS))
def test_sim_pooling_matches_jax(name):
    rng = np.random.default_rng(2)
    multi = name in MULTI_TEXT_POOLINGS
    sim = rng.uniform(0.05, 1.0, (3, 6, 4) if multi else (3, 3, 6, 4))
    feed = {"sim": sim.astype(np.float32),
            "audio_len": np.array([6, 4, 2], np.int64),
            "text_len": np.array([4, 1, 3], np.int64)}
    ref = np.asarray(jregistry.instantiate({"type": name, "args": {}})(feed))
    got = instantiate({"type": name, "args": {}})(
        to_device(feed, CPU)).numpy()
    assert got.shape == ref.shape == ((3, 4) if multi else (3, 3))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_pack_phrases_matches_jax():
    rng = np.random.default_rng(3)
    flat = rng.normal(size=(6, 5)).astype(np.float32)
    nums = np.array([3, 1, 2], np.int64)
    pad_index = np.array([[0, 1, 2], [3, 0, 0], [4, 5, 0]], np.int64)
    ref = np.asarray(jalign_models._pack_phrases(flat, pad_index, nums))
    got = pack_phrases(torch.from_numpy(flat), torch.from_numpy(pad_index),
                       torch.from_numpy(nums)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert not got[1, 1:].any()


# --------------------------------------------------------------- data
@pytest.fixture(scope="module")
def caption_data(tmp_path_factory):
    """Six 1.5 s clips in the grounding label JSON's layout, two phrases
    longer than 4 words, a vocabulary over their words."""
    root = tmp_path_factory.mktemp("captions")
    wav_csv, label_json, _ = make_grounding_data(
        root, num_audio=6, duration=1.5, max_phrases=3, seed=5)
    label = json.loads(label_json.read_text())
    # clip 0: one phrase, too long for max_phrase_words 4; clip 1: a long
    # phrase beside short ones
    label[0]["phrases"] = label[0]["phrases"][:1]
    label[0]["phrases"][0]["phrase"] = "a dog barking loudly far away now"
    label[1]["phrases"].append({**label[1]["phrases"][0],
                                "phrase": "door slamming loudly far away"})
    label_json.write_text(json.dumps(label))
    vocab = Vocabulary()
    for word in ["<pad>", "<unk>"] + sorted(
            {w for it in label for p in it["phrases"]
             for w in p["phrase"].split()}):
        vocab.add_word(word)
    vocab.save(root / "vocab.pkl")
    return {"wav": str(wav_csv), "label": str(label_json),
            "vocab": str(root / "vocab.pkl")}


def _same(got: dict, ref: dict) -> None:
    assert list(got) == list(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


_DATASETS = {
    "AudioCaptionPhrasesEvalDataset": {},
    "AudioCaptionPhrasesDataset": {"max_phrase_words": 4},
    "SinglePhraseEvalDataset": {},
    "AudioCaptionDataset": {"max_audio_length": 1.0, "max_cap_length": 3,
                            "seed": 4},
    "AudioCaptionPhraseIndicesDataset": {"max_audio_length": 1.0,
                                         "seed": 4},
}


@pytest.mark.parametrize("name", list(_DATASETS))
def test_caption_dataset_matches_jax(caption_data, name):
    args = {"waveform": caption_data["wav"], "label": caption_data["label"],
            **_DATASETS[name]}
    ref_ds = getattr(jdatasets, name)(**args)
    got_ds = getattr(datasets, name)(**args)
    assert len(got_ds) == len(ref_ds) > 0
    if name == "AudioCaptionPhrasesDataset":
        assert len(got_ds) == 5                 # the long phrase's clip
    for salt in (None, 7):
        if salt is not None:
            if not hasattr(ref_ds, "rng"):
                break
            ref_ds.reseed(salt)
            got_ds.reseed(salt)
        for i in range(len(ref_ds)):
            _same(got_ds[i], ref_ds[i])


def test_sample_phrases_count_dataset_matches_jax(tmp_path):
    make_grounding_data(tmp_path, num_audio=4, duration=1.0, max_phrases=2,
                        seed=6, phrases_as_str=True)
    (tmp_path / "audio.csv").write_text(
        (tmp_path / "waveform.csv").read_text().replace("hdf5_path",
                                                        "file_path"))
    label = json.loads((tmp_path / "label.json").read_text())
    counts = {p: i + 1 for i, p in enumerate(
        sorted({p for it in label for p in it["phrases"]})[:-1])}
    (tmp_path / "count.json").write_text(json.dumps(counts))
    args = {"audio": str(tmp_path / "audio.csv"),
            "label": str(tmp_path / "label.json"), "phrase_num": 4,
            "fix_neg": False, "neg_samp_stratg": "random", "seed": 2,
            "phrase_count": str(tmp_path / "count.json")}
    ref_ds = jdatasets.SamplePhrasesCountDataset(**args)
    got_ds = datasets.SamplePhrasesCountDataset(**args)
    for i in range(len(ref_ds)):
        ref, got = ref_ds[i], got_ds[i]
        ref["phrases"] = [str(p) for p in ref["phrases"]]
        got["phrases"] = [str(p) for p in got["phrases"]]
        _same(got, ref)


def test_varnum_text_collate_matches_jax(caption_data):
    items = datasets.AudioCaptionPhrasesDataset(caption_data["wav"],
                                                caption_data["label"])
    batch = [items[i] for i in range(4)]
    kwargs = {"text_key": "phrases", "pad_keys": ["waveform"],
              "pad_buckets": {"waveform": 32000}, "text_bucket": 4}
    ref = jcollate.VarNumTextCollate(JTok(caption_data["vocab"]),
                                     **kwargs)(batch)
    got = collate.VarNumTextCollate(DictTokenizer(caption_data["vocab"]),
                                    **kwargs)(batch)
    _same(got, ref)
    assert got["phrases_num"].dtype == got["phrases_pad_index"].dtype \
        == np.int64
    assert got["phrases"].shape[0] == got["phrases_num"].sum()


# ------------------------------------------------------------- models
def _waves(rng) -> dict:
    return {"waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(
        np.float32), "waveform_len": np.array([32000, 21000], np.int32)}


def _phrase_batch(rng) -> dict:
    nums = np.array([3, 2], np.int64)
    lens = np.array([3, 2, 1, 3, 2], np.int32)
    tokens = rng.integers(2, _VOCAB, (5, 3)).astype(np.int32)
    tokens[np.arange(3)[None, :] >= lens[:, None]] = 0
    return {**_waves(rng), "phrases": tokens, "phrases_len": lens,
            "phrases_num": nums,
            "phrases_pad_index": np.array([[0, 1, 2], [3, 4, 0]], np.int64)}


def _word_batch(rng) -> dict:
    lens = np.array([5, 3], np.int32)
    tokens = rng.integers(2, _VOCAB, (2, 5)).astype(np.int32)
    tokens[np.arange(5)[None, :] >= lens[:, None]] = 0
    return {**_waves(rng), "text": tokens, "text_len": lens}


def align_model_config(name: str, embed: int = 512) -> dict:
    """An align model over the full-width Cnn8Rnn, as the sentence
    configs build it; ``cross`` scores through ``CrossAttentionGating``
    and a token-level ``DotProduct``."""
    cfg = {"type": name, "args": {"shared_dim": 64, "add_proj": False},
           "audio_encoder": {"type": "Cnn8Rnn",
                             "args": {"sample_rate": 32000}},
           "text_encoder": {"type": "EmbeddingAgg",
                            "args": {"vocab_size": _VOCAB,
                                     "embed_dim": embed}},
           "match_fn": {"type": "AlignDotProduct", "args": {}},
           "sim_pooling": {"type": "AudioMeanTextMean", "args": {}}}
    if name == "AudioTextCrossAlignByPhrase":
        cfg["match_fn"] = {"type": "DotProduct",
                           "args": {"text_level": "token"}}
        cfg["cross_encoder"] = {"type": "CrossAttentionGating",
                                "args": {"embed_dim": 512}}
    return cfg


_ALIGN_MODELS = {"word": ("AudioTextAlignByWord", 64, _word_batch),
                 "phrase": ("AudioTextAlignByPhrase", 64, _phrase_batch),
                 "cross_phrase": ("AudioTextCrossAlignByPhrase", 512,
                                  _phrase_batch)}


@pytest.mark.parametrize("case", list(_ALIGN_MODELS))
def test_align_model_forward_matches_jax(case):
    name, embed, make = _ALIGN_MODELS[case]
    batch = {**make(np.random.default_rng(11)), "output_matrix": True}
    cfg = align_model_config(name, embed)
    jmodel = jregistry.instantiate(cfg)
    model = instantiate(cfg, device="cpu")
    assert model.needs_proj == (case != "cross_phrase")
    jbatch = {k: v for k, v in batch.items() if k != "output_matrix"}
    variables = jax_variables(jmodel, jbatch, model, seed=5)
    ref = jax_forward(jmodel, variables, jbatch, output_matrix=True)
    with torch.no_grad():
        out = model({**to_device(jbatch, CPU), "output_matrix": True})
    assert out["sim"].shape == (2, 2)
    assert out["sim_matrix"].shape == ref["sim_matrix"].shape
    assert out["sim_matrix"].shape[:3] == (2, 2, 25)
    for key in ("sim", "sim_matrix"):
        rel = _rel_rms(out[key].numpy(), np.asarray(ref[key]))
        assert rel <= 1e-4, (key, rel)
