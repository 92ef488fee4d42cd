"""The port's cross encoder, token-level and cross-attention match
functions, linear upsampling and the broadcast branch of the phrase
models against the JAX package.

Same numpy inputs made from a seed; weights drawn with numpy over JAX's
parameter shapes (``jax.eval_shape`` of the init), the towers' carried
from the port's ``random_state_dict``, all loaded into the port through
``from_jax_variables``, strictly.  Tolerances:

* token-level ``DotProduct`` / ``ExpNegL2``, ``CrossAttention``,
  ``CrossAttentionGating`` and ``linear_upsample`` (against
  ``jax.image.resize``): 1e-6 (rtol and atol);
* at the full Cnn8Rnn width on 1 s clips, batch 2, within 1e-4 relative
  RMS (as ``tests/test_torch_port_weak.py`` holds ``MultiTextBiEncoder``):
  the broadcast branch of ``MultiTextBiEncoder`` with
  ``CrossAttentionGating`` and a token-level ``DotProduct`` (widths 512,
  no projection), and with ``CrossAttention(512, 8)`` as the match
  function; ``BiEncoder`` with ``upsample=True``;
  ``MultiTextBiEncoderWithAlign`` (``clip_sim``, ``sentence_sim`` and
  ``sim_matrix``) with ``CrossAttentionGating`` and a token-level
  ``ExpNegL2`` after projections to 64, ``max`` phrase pooling and
  ``upsample=True``, with a label (the sentence branch) and without
  one (no sentence branch).  The JAX forwards are jitted with the weights
  and the batch as arguments, the Cnn8Rnn tower once for every model
  (``tests/test_torch_port_align.py:jax_forward``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_align import jax_forward, jax_variables
from tests.test_torch_port_train import _rel_rms
from texttoaudiogrounding_tpu.models import audio_text_model as jatm
from texttoaudiogrounding_tpu.models import cross_encoder as jcross
from texttoaudiogrounding_tpu.models import match as jmatch
from texttoaudiogrounding_tpu.utils import registry as jregistry
from texttoaudiogrounding_tpu_torch import weights
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.models import (
    CrossAttention,
    CrossAttentionGating,
    DotProduct,
    ExpNegL2,
)
from texttoaudiogrounding_tpu_torch.models.audio_text_model import (
    linear_upsample,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

_VOCAB = 60
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(shapes, seed: int) -> dict:
    """Every leaf of a JAX shape tree drawn with numpy at flax's scales."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "v":
            return rng.normal(0.0, 1.0, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.05, x.shape).astype(np.float32)
        return rng.normal(0.0, x.shape[0] ** -0.5, x.shape).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_weights(module, params: dict) -> None:
    """The module's weights from its flax tree, loaded strictly through
    ``from_jax_variables``."""
    module.load_state_dict(weights.from_jax_variables({"params": params},
                                                      module))


def _lens_rows(rng, p: int, t: int, d: int) -> tuple:
    return (rng.normal(size=(p, t, d)).astype(np.float32),
            np.array([t, t - 2, 1, t // 2][:p], np.int64))


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("match", ["DotProduct", "ExpNegL2"])
def test_token_level_match_matches_jax(match):
    rng = np.random.default_rng(1)
    audio = rng.normal(size=(3, 6, 8)).astype(np.float32)
    tokens = rng.normal(size=(3, 6, 8)).astype(np.float32)
    jfn = getattr(jmatch, match)(text_level="token")
    fn = {"DotProduct": DotProduct, "ExpNegL2": ExpNegL2}[match](
        text_level="token")
    ref = np.asarray(jfn({"audio_emb": audio, "text_emb": {
        "token_emb": tokens, "seq_emb": tokens[:, 0]}}))
    got = fn(torch.from_numpy(audio), {"token_emb": torch.from_numpy(tokens),
                                       "seq_emb": None})
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_cross_attention_matches_jax():
    rng = np.random.default_rng(2)
    audio, _ = _lens_rows(rng, 4, 7, 16)
    tokens, text_len = _lens_rows(rng, 4, 5, 16)
    text_len[2] = 0                     # no valid token: uniform in flax
    feed = {"audio_emb": audio, "text_emb": {"token_emb": tokens},
            "text_len": text_len}
    jfn = jmatch.CrossAttention(embed_dim=16, num_heads=4)
    params = _np_tree(jax.eval_shape(lambda: jfn.init(
        jax.random.PRNGKey(0), feed))["params"], 3)
    ref = np.asarray(jax.jit(jfn.apply)({"params": params}, feed))
    fn = CrossAttention(16, 4)
    _port_weights(fn, params)
    got = fn(torch.from_numpy(audio), {"token_emb": torch.from_numpy(tokens)},
             torch.from_numpy(text_len))
    assert got.shape == (4, 7)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)


def test_cross_attention_gating_matches_jax():
    rng = np.random.default_rng(4)
    audio, audio_len = _lens_rows(rng, 4, 7, 16)
    tokens, text_len = _lens_rows(rng, 4, 5, 16)
    feed = {"audio_emb": audio, "text_emb": {"token_emb": tokens},
            "audio_len": audio_len, "text_len": text_len}
    jfn = jcross.CrossAttentionGating(embed_dim=16)
    params = _np_tree(jax.eval_shape(lambda: jfn.init(
        jax.random.PRNGKey(0), feed))["params"], 5)
    ref = jax.jit(jfn.apply)({"params": params}, feed)
    fn = CrossAttentionGating(16)
    _port_weights(fn, params)
    got = fn({k: (to_device(v, CPU) if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in feed.items()})
    for out, want in ((got["audio_emb"], ref["audio_emb"]),
                      (got["text_emb"]["token_emb"],
                       ref["text_emb"]["token_emb"])):
        assert out.shape == (4, 7, 16)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 25, 3), (3, 7)])
def test_linear_upsample_matches_jax(shape):
    x = np.random.default_rng(6).uniform(size=shape).astype(np.float32)
    ref = np.asarray(jatm._linear_upsample(
        jnp.asarray(x if x.ndim == 3 else x[..., None]), 4))
    got = linear_upsample(torch.from_numpy(x), 4).numpy()
    assert got.shape == (shape[0], shape[1] * 4) + shape[2:]
    np.testing.assert_allclose(got, ref.reshape(got.shape), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------- models
def _batch(n: int = 3) -> dict:
    rng = np.random.default_rng(11)
    text_len = rng.integers(1, 4, (2, n)).astype(np.int32)
    text = rng.integers(2, _VOCAB, (2, n, 3)).astype(np.int32)
    text[np.arange(3)[None, None, :] >= text_len[..., None]] = 0
    return {
        "waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(np.float32),
        "waveform_len": np.array([32000, 21000], np.int32),
        "text": text, "text_len": text_len,
        "label": np.array([[1] * (n - 1) + [0], [1] + [0] * (n - 1)],
                          np.float32)}


def _model_config(case: str) -> dict:
    kind, match, cross, embed, extra = _MODELS[case]
    cfg = {"type": kind,
           "args": {"shared_dim": 64, "add_proj": embed == 64, **extra},
           "audio_encoder": {"type": "Cnn8Rnn",
                             "args": {"sample_rate": 32000}},
           "text_encoder": {"type": "EmbeddingAgg",
                            "args": {"vocab_size": _VOCAB,
                                     "embed_dim": embed}},
           "match_fn": match}
    if cross:
        cfg["cross_encoder"] = {"type": "CrossAttentionGating",
                                "args": {"embed_dim": embed}}
    if kind == "MultiTextBiEncoderWithAlign":
        cfg["align_fn"] = {"type": "AlignDotProduct", "args": {}}
        cfg["sentence_pooling"] = {"type": "AudioMeanTextMean", "args": {}}
    return cfg


_TOKEN_DOT = {"type": "DotProduct", "args": {"text_level": "token"}}
# (model, match function, CrossAttentionGating, text width, model args)
_MODELS = {
    "gating_dot_token": ("MultiTextBiEncoder", _TOKEN_DOT, True, 512, {}),
    "cross_attention": (
        "MultiTextBiEncoder",
        {"type": "CrossAttention", "args": {"embed_dim": 512,
                                            "num_heads": 8}}, False, 512,
        {}),
    "biencoder_upsample": ("BiEncoder", {"type": "DotProduct", "args": {}},
                           False, 64, {"upsample": True}),
    "with_align_gating_expnegl2_proj": (
        "MultiTextBiEncoderWithAlign",
        {"type": "ExpNegL2", "args": {"text_level": "token"}}, True, 64,
        {"upsample": True, "phrase_pooling": "max"}),
}


@pytest.mark.parametrize("case", list(_MODELS))
def test_broadcast_and_upsample_models_match_jax(case):
    batch = _batch()
    if case == "biencoder_upsample":
        batch = {**batch, "text": batch["text"][:, 0],
                 "text_len": batch["text_len"][:, 0]}
    cfg = _model_config(case)
    jmodel, model = jregistry.instantiate(cfg), instantiate(cfg, device="cpu")
    assert model.needs_proj == (cfg["text_encoder"]["args"]["embed_dim"]
                                == 64)
    variables = jax_variables(jmodel, batch, model, seed=7)
    align = case.startswith("with_align")
    flags = {"output_matrix": True} if align else {}
    ref = jax_forward(jmodel, variables, batch, **flags)
    with torch.no_grad():
        out = model({**to_device(batch, CPU), **flags})
    t = 25 if cfg["type"] == "MultiTextBiEncoder" else 100
    assert out["frame_sim"].shape[:2] == ref["frame_sim"].shape[:2] == (2, t)
    np.testing.assert_array_equal(out["length"].numpy(),
                                  np.asarray(ref["length"]))
    keys = [k for k in ("frame_sim", "clip_sim", "sentence_sim",
                        "sim_matrix") if k in ref]
    assert sorted(k for k in out if k != "logit") == sorted(keys + [
        "length"])
    assert ("sentence_sim" in keys) == align == ("sim_matrix" in keys)
    for key in keys:
        rel = _rel_rms(out[key].numpy(), np.asarray(ref[key]))
        assert rel <= 1e-4, (key, rel)
    if align:                        # no label: no sentence_sim
        with torch.no_grad():
            out = model({**{k: v for k, v in to_device(batch, CPU).items()
                            if k != "label"}, **flags})
        assert set(out) == {"frame_sim", "clip_sim", "length"}
