"""The port's transformer text towers, their HF-checkpoint importers, the HF
tokenizer, the released grounding model and the registry against the JAX
package (and ``transformers``).

Inputs come from a numpy seed; weights are drawn with numpy over the JAX
modules' parameter shapes (``jax.eval_shape`` of the init) and go into the
port through ``weights.from_jax_variables(variables, model)``, strictly.
Every batch holds a padded row and a row of one token.  Tolerances:

* ``TextTower``, ``Bert``, ``SentenceBert`` and ``ClapTextEncoder`` on
  ``tiny_text_tower_config`` and at width 768 (12 heads, 3,072 inner, 2
  layers, vocabulary 1,000, RoBERTa's position offset and pad): 1e-5
  (rtol and atol);
* ``import_hf_bert_params`` / ``import_clap_text_params`` on the state
  dicts of a ``transformers`` ``BertModel`` / ``RobertaModel`` built from a
  config in code: the port's tower against ``last_hidden_state`` (RoBERTa
  at the valid positions: HF numbers the valid tokens only) and against
  JAX's imported tower, 1e-5;
* the released model (full-width Cnn8Rnn, tiny text tower, 1 s clips,
  batch 2): f32 within 1e-4 relative RMS of JAX, also through both
  packages' ``import_hf_grounding`` of one reference-format checkpoint;
  the serving model (plain kernel versions on the CPU) within 0.05 of the
  port's f32 ``frame_sim``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.models import hf_api as jhf
from texttoaudiogrounding_tpu.models import pretrained_text as jpt
from texttoaudiogrounding_tpu.training import torch_import as jimport
from texttoaudiogrounding_tpu_torch.models import hf_api
from texttoaudiogrounding_tpu_torch.models import pretrained_text as pt
from texttoaudiogrounding_tpu_torch.weights import from_jax_variables

_PKG = Path(__file__).resolve().parents[1] / "texttoaudiogrounding_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ helpers
_POOL = 1_048_573                    # a prime


def np_tree(shapes, seed: int) -> dict:
    """Every leaf of a JAX shape tree drawn with numpy: LayerNorm / BN
    scales near 1, small biases, running statistics of a unit input, and
    kernels at 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal(_POOL, dtype=np.float32)

    def normal(shape, std):
        # large leaves repeat a pool of a prime length: as random as the
        # parity tests need, without drawing every full-width weight
        n = int(np.prod(shape))
        draw = (rng.standard_normal(n, dtype=np.float32) if n <= _POOL
                else np.resize(np.roll(pool, int(rng.integers(_POOL))), n))
        return draw.reshape(shape) * np.float32(std)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "var"):
            return rng.random(x.shape, dtype=np.float32) + np.float32(0.5)
        if name in ("bias", "mean"):
            return normal(x.shape, 0.05)
        fan = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
        return normal(x.shape, fan ** -0.5)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(jmodel, batch: dict, seed: int, **kw) -> dict:
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, batch, **kw))
    return np_tree(shapes, seed)


def to_port(model, variables: dict):
    model.load_state_dict(from_jax_variables(variables, model))   # strict
    return model.eval()


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)
                         / max(np.mean(ref ** 2), 1e-30)))


def token_batch(rng, vocab: int, lo: int = 3) -> dict:
    ids = rng.integers(lo, vocab, size=(3, 7))
    mask = np.ones((3, 7), np.int64)
    mask[1, 4:] = 0                       # a padded row
    mask[2, 1:] = 0                       # one token
    return {"input_ids": ids, "attention_mask": mask}


def _cfgs(cls):
    tiny = cls.TextTowerConfig(vocab_size=100, hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=64,
                               max_position_embeddings=64, type_vocab_size=2)
    wide = cls.TextTowerConfig(vocab_size=1000, hidden_size=768,
                               num_layers=2, num_heads=12,
                               intermediate_size=3072,
                               max_position_embeddings=514,
                               type_vocab_size=1, layer_norm_eps=1e-5,
                               pad_token_id=1, position_offset=2)
    return {"tiny": tiny, "wide": wide}


_ENCODERS = {"Bert": {}, "SentenceBert": {},
             "ClapTextEncoder": {"projection_dim": 64}}


# ------------------------------------------------------------- towers
@pytest.mark.parametrize("width", ["tiny", "wide"])
@pytest.mark.parametrize("name", ["TextTower", *_ENCODERS])
def test_text_tower_matches_jax(name, width):
    jcfg, cfg = _cfgs(jpt)[width], _cfgs(pt)[width]
    batch = token_batch(np.random.default_rng(1), jcfg.vocab_size)
    if name == "TextTower":
        jm, args = jpt.TextTower(jcfg), (batch["input_ids"],
                                         batch["attention_mask"])
        variables = np_tree(jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), *args)), 2)
        ref = dict(zip(("hidden", "pooled"), jax.jit(jm.apply)(variables,
                                                                *args)))
        model = to_port(pt.TextTower(cfg, device="cpu"), variables)
        with torch.no_grad():
            got = dict(zip(("hidden", "pooled"), model(
                *map(torch.from_numpy, args))))
    else:
        jm = getattr(jpt, name)(jcfg, **_ENCODERS[name])
        variables = jax_variables(jm, batch, 2)
        ref = jax.jit(jm.apply)(variables, batch)
        model = to_port(getattr(pt, name)(cfg, **_ENCODERS[name],
                                          device="cpu"), variables)
        with torch.no_grad():
            got = model(torch_batch(batch))
    for key in ("hidden", "pooled", "seq_emb", "token_emb"):
        if key in ref:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


def test_tower_names_are_hf_keys():
    cfg = _cfgs(pt)["tiny"]
    tower = pt.TextTower(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in tower.state_dict().items()} == \
        pt.tower_shapes(cfg)


# ------------------------------------------------------------ importers
def _hf_model(kind: str):
    from transformers import BertConfig, BertModel, RobertaConfig, RobertaModel
    common = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, hidden_act="gelu",
                  attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    if kind == "bert":
        model = BertModel(BertConfig(vocab_size=120,
                                     max_position_embeddings=64,
                                     type_vocab_size=2, **common))
    else:
        model = RobertaModel(RobertaConfig(
            vocab_size=120, max_position_embeddings=66, type_vocab_size=1,
            pad_token_id=1, layer_norm_eps=1e-5, **common))
    return model.eval()


@pytest.fixture(scope="module")
def hf_models():
    os.environ.setdefault("USE_TF", "0")
    return {kind: _hf_model(kind) for kind in ("bert", "roberta")}


@pytest.mark.parametrize("kind", ["bert", "roberta"])
def test_import_hf_bert_matches_transformers_and_jax(hf_models, kind):
    model = hf_models[kind]
    sd = model.state_dict()
    cfg = pt.config_from_hf(model.config)
    jcfg = jpt.config_from_hf(model.config)
    batch = token_batch(np.random.default_rng(4), 120)
    tower = pt.TextTower(cfg, device="cpu")
    tower.load_state_dict(pt.import_hf_bert_params(sd, cfg))
    with torch.no_grad():
        hidden, pooled = tower(*map(torch.from_numpy, (
            batch["input_ids"], batch["attention_mask"])))
        ref = model(input_ids=torch.from_numpy(batch["input_ids"]),
                    attention_mask=torch.from_numpy(batch["attention_mask"]))
    valid = batch["attention_mask"].astype(bool) if kind == "roberta" \
        else np.ones_like(batch["attention_mask"], bool)
    np.testing.assert_allclose(hidden.numpy()[valid],
                               ref.last_hidden_state.numpy()[valid],
                               rtol=1e-5, atol=1e-5)
    jparams = jpt.import_hf_bert_params({k: v.numpy() for k, v in sd.items()},
                                        jcfg)
    jhidden, jpooled = jpt.TextTower(jcfg).apply(
        {"params": jparams}, batch["input_ids"], batch["attention_mask"])
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pooler", [True, False])
def test_import_clap_text_params_matches_jax(hf_models, pooler):
    """A ``ClapModel``-format state dict (``text_model.*`` from the
    RobertaModel, ``text_projection.linear1/2`` drawn with numpy), with and
    without the pooler (then the identity, as in JAX)."""
    model = hf_models["roberta"]
    rng = np.random.default_rng(5)
    sd = {f"text_model.{k}": v.numpy() for k, v in model.state_dict().items()
          if pooler or not k.startswith("pooler.")}
    for name, shape in (("linear1", (32, 64)), ("linear2", (32, 32))):
        sd[f"text_projection.{name}.weight"] = rng.normal(
            0, 0.1, shape).astype(np.float32)
        sd[f"text_projection.{name}.bias"] = rng.normal(
            0, 0.05, shape[:1]).astype(np.float32)
    cfg, jcfg = (m.config_from_hf(model.config) for m in (pt, jpt))
    enc = pt.ClapTextEncoder(cfg, projection_dim=32, device="cpu")
    enc.load_state_dict(pt.import_clap_text_params(sd, cfg))
    batch = token_batch(rng, 120)
    ref = jpt.ClapTextEncoder(jcfg, projection_dim=32).apply(
        {"params": jpt.import_clap_text_params(sd, jcfg)}, batch)
    with torch.no_grad():
        got = enc(torch_batch(batch))
    for key in ("seq_emb", "token_emb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_import_hf_bert_checks_keys_and_shapes(hf_models):
    sd = dict(hf_models["bert"].state_dict())
    cfg = pt.config_from_hf(hf_models["bert"].config)
    del sd["encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.bias"):
        pt.import_hf_bert_params(sd, cfg)
    sd["encoder.layer.1.output.dense.bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        pt.import_hf_bert_params(sd, cfg)


def test_hf_tokenizer_matches_jax(tmp_path):
    os.environ.setdefault("USE_TF", "0")
    from transformers import BertTokenizer

    from texttoaudiogrounding_tpu.data.tokenizer import (
        HuggingFaceTokenizer as JTok)
    from texttoaudiogrounding_tpu_torch.data.tokenizer import (
        HuggingFaceTokenizer)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog",
             "barks", "man", "speaks", "rain", "##s"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(
        str(tmp_path / "tok"))
    ours, theirs = HuggingFaceTokenizer(str(tmp_path / "tok")), JTok(
        str(tmp_path / "tok"))
    for texts in (["a dog barks", "rains"],
                  [["a man speaks", "dog"], ["rain", "a dog barks"]]):
        got, ref = ours(texts), theirs(texts)
        assert sorted(got) == sorted(ref) and "token_type_ids" in got
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
    with pytest.raises(TypeError):
        ours("a dog")


# ------------------------------------------------------ released model
def _tiny_clap(mod):
    return mod.TextTowerConfig(vocab_size=100, hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=64,
                               max_position_embeddings=64, type_vocab_size=1,
                               layer_norm_eps=1e-5, pad_token_id=1,
                               position_offset=2)


def _clip_batch() -> dict:
    rng = np.random.default_rng(7)
    ids = rng.integers(3, 100, size=(2, 5))
    ids[:, 0] = 0
    mask = np.ones((2, 5), np.int64)
    mask[1, 3:] = 0
    ids[1, 2], ids[1, 3:] = 2, 1
    return {"waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(
        np.float32), "waveform_len": np.array([32000, 21000]),
        "input_ids": ids, "attention_mask": mask}


def reference_checkpoint(model, seed: int) -> dict:
    """``hf_api.random_reference_checkpoint``, under the reference
    deployment's names."""
    ckpt = hf_api.random_reference_checkpoint(model, seed)
    assert "text_encoder.model.pooler.dense.weight" in ckpt
    assert "text_encoder.projection.linear2.bias" in ckpt
    return ckpt


@pytest.fixture(scope="module")
def released():
    """(batch, JAX f32 output, port f32 model) for weights from one
    reference-format checkpoint, imported by both packages."""
    batch = _clip_batch()
    model = hf_api.cnn8rnn_laionclap_grounding_model(
        text_config=_tiny_clap(pt), device="cpu")
    ckpt = reference_checkpoint(model, seed=3)
    model.load_state_dict(hf_api.import_hf_grounding(ckpt, _tiny_clap(pt)))
    jmodel = jhf.cnn8rnn_laionclap_grounding_model(
        text_config=_tiny_clap(jpt))
    variables = jimport.import_hf_grounding(
        {k: v.numpy() for k, v in ckpt.items()}, _tiny_clap(jpt))
    ref = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, batch)
    return batch, jax.tree.map(np.asarray, ref), model, variables


def test_released_model_f32_matches_jax(released):
    batch, ref, model, _ = released
    with torch.no_grad():
        got = model(torch_batch(batch))
    assert got["frame_sim"].shape == (2, 25)
    np.testing.assert_array_equal(got["length"].numpy(), ref["length"])
    assert rel_rms(got["frame_sim"].numpy(), ref["frame_sim"]) <= 1e-4


def test_released_model_from_jax_variables(released):
    """The same weights through ``from_jax_variables`` (the JAX tree)
    give the model ``import_hf_grounding`` gave."""
    _, _, model, variables = released
    sd = from_jax_variables(variables, model)
    for key, value in model.state_dict().items():
        if "bias_hh" in key:       # r/z folded into the input bias in JAX
            continue
        if "bias_ih" in key:
            continue
        torch.testing.assert_close(sd[key], value, rtol=0, atol=0,
                                   msg=key)


def test_released_model_serving_near_f32(released):
    batch, _, model, _ = released
    serving = hf_api.cnn8rnn_laionclap_grounding_model(
        text_config=_tiny_clap(pt), serving=True, device="cpu")
    serving.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = serving(torch_batch(batch))["frame_sim"]
        want = model(torch_batch(batch))["frame_sim"]
    assert float((got - want).abs().max()) <= 0.05
    assert serving.audio_encoder.conv_block1.conv_mode == "int8"


def test_import_hf_grounding_rejects_unknown_keys(released):
    ckpt = reference_checkpoint(released[2], seed=3)
    ckpt["text_encoder.extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="text_encoder.extra.weight"):
        hf_api.import_hf_grounding(ckpt, _tiny_clap(pt))


def test_released_factory_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hf_api.cnn8rnn_laionclap_grounding_model(text_config=_tiny_clap(pt))
    for make in (lambda: pt.TextTower(_tiny_clap(pt)),
                 lambda: pt.ClapTextEncoder(_tiny_clap(pt), 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# -------------------------------------------------------------- registry
# JAX registry names with no counterpart in the port's, and why
BY_DESIGN = {
    "DataLoader": "its seed / prefetch / worker_type / shard_index / "
                  "num_shards arguments are not torch.utils.data."
                  "DataLoader's; the runners build their loaders with "
                  "data/loader.py:build_loader",
}


def _jax_registry() -> dict:
    import importlib
    import pkgutil

    import texttoaudiogrounding_tpu as jpkg
    from texttoaudiogrounding_tpu.utils.registry import get_registry
    for info in pkgutil.walk_packages(jpkg.__path__,
                                      "texttoaudiogrounding_tpu."):
        if info.name.endswith("libttgdecode"):
            continue
        importlib.import_module(info.name)
    return get_registry()


def test_every_jax_registry_name_resolves():
    from texttoaudiogrounding_tpu_torch.utils.registry import resolve
    missing = []
    for name in sorted(_jax_registry()):
        if name in BY_DESIGN:
            with pytest.raises(KeyError):
                resolve(name)
            continue
        try:
            resolve(name)
        except KeyError:
            missing.append(name)
    assert not missing, missing


def test_new_modules_import_nothing_forbidden():
    """The slice's modules import no JAX, no JAX package and none of
    ``transformers``, ``sklearn``, ``pandas``, ``h5py`` (the card's
    machine has none of them)."""
    code = (
        "import sys\n"
        "import texttoaudiogrounding_tpu_torch.models as m\n"
        "import texttoaudiogrounding_tpu_torch.models.hf_api\n"
        "import texttoaudiogrounding_tpu_torch.data.tokenizer\n"
        "import texttoaudiogrounding_tpu_torch.utils.registry as r\n"
        "r._fill()\n"
        "from texttoaudiogrounding_tpu_torch.tools import (clustering, "
        "embeddings, label_tools, map_phrase_to_event, pack_waveform, "
        "phrase_parser, score_backends)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', "
        "'jaxlib', 'flax', 'texttoaudiogrounding_tpu', 'transformers', "
        "'sklearn', 'pandas', 'h5py')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(_PKG.parent))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(_PKG.parent))
