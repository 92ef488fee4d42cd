"""The PyTorch port's serving slice against the JAX package.

Same weights (the JAX init, carried over by ``from_jax_variables``) and
the same numpy inputs go through the JAX ``BiEncoder`` and the port's, on
1 s clips with the flagship's full-width Cnn8Rnn and a narrow text tower:

* f32: the port's plain path against the JAX f32 model — audio embedding
  within relative 1e-4;
* int8 serving: the port's kernels' plain versions (CPU) against the JAX
  serving model with its Pallas kernels in interpret mode
  (``TTG_PALLAS_INTERPRET=1``, ``TTG_FUSED_CONV=int8``) — audio embedding
  within relative RMS 2e-2, pre-sigmoid logits compared alongside, and
  ``frame_sim`` within 5e-3 through ``GroundingPredictor.predict``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.data.tokenizer import DictTokenizer as JTok
from texttoaudiogrounding_tpu.data.vocabulary import Vocabulary as JVocab
from texttoaudiogrounding_tpu.inference import GroundingPredictor as JPred
from texttoaudiogrounding_tpu.models import BiEncoder as JBiEncoder
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.match import DotProduct as JDotProduct
from texttoaudiogrounding_tpu.training.torch_import import export_biencoder
from texttoaudiogrounding_tpu_torch import (
    BiEncoder,
    Cnn8Rnn,
    DotProduct,
    EmbeddingAgg,
    GroundingPredictor,
    flagship_model,
    from_jax_variables,
)
from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary

_VOCAB, _EMBED = 100, 32
_WORDS = ["<pad>", "<unk>", "a", "dog", "barks", "man", "speaking"]
_PKG = Path(__file__).resolve().parents[1] / "texttoaudiogrounding_tpu_torch"


def _jax_model(dtype):
    return JBiEncoder(
        audio_encoder=JCnn8Rnn(sample_rate=32000, dtype=dtype),
        text_encoder=JEmbeddingAgg(vocab_size=_VOCAB, embed_dim=_EMBED),
        match_fn=JDotProduct(), shared_dim=_EMBED, add_proj=True)


def _port_model(serving: bool):
    audio = (Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8") if serving
             else Cnn8Rnn())
    return BiEncoder(audio, EmbeddingAgg(_VOCAB, _EMBED), DotProduct(),
                     shared_dim=_EMBED, add_proj=True, device="cpu")


def _batch():
    rng = np.random.default_rng(11)
    return {
        "waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(np.float32),
        "waveform_len": np.array([32000, 21000], np.int32),
        "text": np.array([[2, 3, 4, 0], [5, 6, 0, 0]], np.int32),
        "text_len": np.array([3, 2], np.int32),
    }


@pytest.fixture(scope="module")
def variables():
    b = _batch()
    return jax.tree.map(np.asarray, _jax_model(jnp.float32).init(
        {"params": jax.random.PRNGKey(0)}, b, train=False))


def _jax_outputs(model, variables, batch):
    """(audio embedding, pre-sigmoid logits, frame_sim, length)."""
    out, inter = model.apply(variables, batch, train=False,
                             capture_intermediates=True,
                             mutable=["intermediates"])
    inter = inter["intermediates"]
    emb = np.asarray(inter["audio_encoder"]["__call__"][0]["embedding"])
    audio = np.asarray(inter["audio_proj"]["__call__"][0], np.float64)
    text = np.asarray(inter["text_proj"]["__call__"][0], np.float64)
    logit = np.einsum("btd,bd->bt", audio, text) / np.sqrt(audio.shape[-1])
    return (emb, logit, np.asarray(out["frame_sim"]),
            np.asarray(out["length"]))


def _port_outputs(model, batch):
    with torch.no_grad():
        tb = {k: torch.from_numpy(np.asarray(v, np.int64)
                                  if v.dtype.kind == "i" else v)
              for k, v in batch.items()}
        emb = model.audio_encoder(tb)["embedding"].numpy()
        out = model(tb)
    return (emb, out["logit"].numpy(), out["frame_sim"].numpy(),
            out["length"].numpy())


def _rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def test_from_jax_variables_round_trip(variables):
    sd = from_jax_variables(variables)
    model = _port_model(serving=False)
    model.load_state_dict(sd, strict=True)
    ref = export_biencoder(variables)
    assert set(ref) <= set(sd)
    for key, value in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(value),
                                      err_msg=key)
    p = variables["params"]["audio_encoder"]
    np.testing.assert_array_equal(
        model.audio_encoder.conv_block3.conv2.weight.detach().numpy(),
        np.asarray(p["conv_block3"]["conv2"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.audio_encoder.rnn.weight_hh_l0_reverse.detach().numpy()[256:512],
        np.asarray(p["rnn"]["GRUCell_1"]["hz"]["kernel"]).T)


def test_f32_biencoder_matches_jax(variables):
    batch = _batch()
    j_emb, j_logit, j_sim, j_len = _jax_outputs(
        _jax_model(jnp.float32), variables, batch)
    model = _port_model(serving=False)
    model.load_state_dict(from_jax_variables(variables))
    emb, logit, sim, length = _port_outputs(model, batch)
    assert emb.shape == j_emb.shape == (2, 25, 512)
    np.testing.assert_array_equal(length, j_len)
    assert np.max(np.abs(emb - j_emb)) <= 1e-4 * np.max(np.abs(j_emb))
    np.testing.assert_allclose(logit, j_logit, atol=1e-4)
    np.testing.assert_allclose(sim, j_sim, atol=1e-5)


def test_int8_serving_matches_jax(variables, monkeypatch):
    monkeypatch.setenv("TTG_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TTG_FUSED_CONV", "int8")
    batch = _batch()
    j_emb, j_logit, j_sim, _ = _jax_outputs(
        _jax_model(jnp.bfloat16), variables, batch)
    model = _port_model(serving=True)
    model.load_state_dict(from_jax_variables(variables))
    emb, logit, sim, _ = _port_outputs(model, batch)
    assert _rel_rms(emb, j_emb) <= 2e-2
    assert _rel_rms(logit, j_logit) <= 2e-2
    assert np.max(np.abs(sim - j_sim)) <= 5e-3

    # the same path through the serving API: tokenization, 1 s audio
    # buckets, batch buckets with a padded sub-batch, padded frames zeroed
    jv, tv = JVocab(), Vocabulary()
    for w in _WORDS:
        jv.add_word(w)
        tv.add_word(w)
    rng = np.random.default_rng(12)
    audio = (rng.normal(size=(3, 30000)) * 0.1).astype(np.float32)
    lens = [30000, 30000, 16000]
    text = ["a dog barks", "man speaking", "dog"]
    jpred = JPred(_jax_model(jnp.bfloat16), variables, JTok(jv),
                  batch_buckets=(2, 4))
    tpred = GroundingPredictor(model, DictTokenizer(tv),
                               batch_buckets=(2, 4))
    j_probs, j_lens = jpred.predict(audio, lens, text, return_length=True)
    probs, plens = tpred.predict(audio, lens, text, return_length=True)
    np.testing.assert_array_equal(plens, j_lens)
    assert probs.shape == j_probs.shape == (3, 25)
    assert np.max(np.abs(probs - j_probs)) <= 5e-3
    assert not probs[2, plens[2]:].any()
    segs = tpred.ground(audio, lens, text)
    assert len(segs) == 3


def test_conv_block_keeps_weights_until_they_change():
    from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock

    def block(seed):
        torch.manual_seed(seed)
        blk = ConvBlock(64, 64, conv_mode="int8").eval()
        for bn in (blk.bn1, blk.bn2):
            bn.running_mean.uniform_(-0.1, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
        return blk

    x = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2, 8, 4, 64)).astype(np.float32)).to(torch.bfloat16)
    blk, other = block(0), block(1)
    first = blk(x, (1, 2))
    kept = blk._kept
    torch.testing.assert_close(blk(x, (1, 2)), first, rtol=0, atol=0)
    assert blk._kept is kept                      # nothing made anew
    blk.load_state_dict(other.state_dict())       # written in place
    torch.testing.assert_close(blk(x, (1, 2)), other(x, (1, 2)),
                               rtol=0, atol=0)
    assert blk._kept is not kept
    with torch.no_grad():
        blk.bn2.running_var.mul_(2.0)
    assert not torch.equal(blk(x, (1, 2)), other(x, (1, 2)))


@pytest.mark.parametrize("b", [1, 3, 8, 9, 33, 128, 130, 300])
def test_chunk_plan_matches_jax(b):
    buckets = (1, 8, 16, 32, 64, 128)
    jpred = JPred(None, None, None, batch_buckets=buckets)
    tpred = GroundingPredictor(torch.nn.Linear(1, 1), None,
                               batch_buckets=buckets)
    assert tpred._chunk_plan(b) == jpred._chunk_plan(b)
    assert GroundingPredictor(torch.nn.Linear(1, 1), None,
                              batch_buckets=())._chunk_plan(b) == [(0, b, b)]


def test_port_imports_no_jax():
    code = ("import sys, texttoaudiogrounding_tpu_torch\n"
            "import texttoaudiogrounding_tpu_torch.inference\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'texttoaudiogrounding_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(_PKG.parent))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(_PKG.parent))
    for path in _PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax",
                                    "texttoaudiogrounding_tpu"), (path, name)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_model(vocab_size=_VOCAB, embed_dim=_EMBED)
    model = flagship_model(device="cpu", vocab_size=_VOCAB, embed_dim=_EMBED)
    assert model.device.type == "cpu"
