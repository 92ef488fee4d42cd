"""The port's serving API on a phrase-level (WSTAG) model, against the JAX
predictor.

A ``MultiTextBiEncoder(Cnn8Rnn, EmbeddingAgg, DotProduct)`` takes text as
``[B, phrases, L]`` and returns ``frame_sim [B, T, phrases]``; both
predictors give each request's text a phrase axis of 1 and keep phrase 0.
The same weights (the JAX init through ``from_jax_variables``) and the same
numpy audio go through both on 1 s clips at the flagship's full Cnn8Rnn
width, in f32: ``frame_sim`` within 5e-3 (the tolerance of the port's
flagship predictor test, ``tests/test_torch_port_model.py``), lengths equal.
"""

import jax
import numpy as np

from texttoaudiogrounding_tpu.data.tokenizer import DictTokenizer as JTok
from texttoaudiogrounding_tpu.data.vocabulary import Vocabulary as JVocab
from texttoaudiogrounding_tpu.inference import GroundingPredictor as JPred
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.audio_text_model import (
    MultiTextBiEncoder as JMultiText,
)
from texttoaudiogrounding_tpu.models.match import DotProduct as JDotProduct
from texttoaudiogrounding_tpu_torch import (
    GroundingPredictor,
    from_jax_variables,
)
from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
from texttoaudiogrounding_tpu_torch.models import (
    Cnn8Rnn,
    DotProduct,
    EmbeddingAgg,
    MultiTextBiEncoder,
)

_VOCAB, _EMBED = 100, 32
_WORDS = ["<pad>", "<unk>", "a", "dog", "barks", "man", "speaking"]


def test_predictor_serves_a_wstag_model_as_jax_does():
    jmodel = JMultiText(
        audio_encoder=JCnn8Rnn(sample_rate=32000),
        text_encoder=JEmbeddingAgg(vocab_size=_VOCAB, embed_dim=_EMBED),
        match_fn=JDotProduct(), shared_dim=_EMBED, add_proj=True,
        pooling="linear_softmax")
    rng = np.random.default_rng(21)
    init_batch = {
        "waveform": np.zeros((2, 32000), np.float32),
        "waveform_len": np.full((2,), 32000, np.int32),
        "text": np.ones((2, 1, 3), np.int32),
        "text_len": np.full((2, 1), 3, np.int32),
    }
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(3)}, init_batch, train=False))
    model = MultiTextBiEncoder(
        Cnn8Rnn(), EmbeddingAgg(_VOCAB, _EMBED), DotProduct(),
        shared_dim=_EMBED, add_proj=True, pooling="linear_softmax",
        device="cpu")
    model.load_state_dict(from_jax_variables(variables, model))  # strict

    jv, tv = JVocab(), Vocabulary()
    for w in _WORDS:
        jv.add_word(w)
        tv.add_word(w)
    audio = (rng.normal(size=(3, 30000)) * 0.1).astype(np.float32)
    lens = [30000, 30000, 16000]
    text = ["a dog barks", "man speaking", "dog"]
    jpred = JPred(jmodel, variables, JTok(jv), batch_buckets=(2, 4))
    tpred = GroundingPredictor(model, DictTokenizer(tv),
                               batch_buckets=(2, 4))
    j_probs, j_lens = jpred.predict(audio, lens, text, return_length=True)
    probs, plens = tpred.predict(audio, lens, text, return_length=True)
    np.testing.assert_array_equal(plens, j_lens)
    assert probs.shape == j_probs.shape == (3, 25)
    assert np.max(np.abs(probs - j_probs)) <= 5e-3
    assert not probs[2, plens[2]:].any()
    assert len(tpred.ground(audio, lens, text)) == 3
