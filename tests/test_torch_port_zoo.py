"""The rest of the port's model zoo against the JAX package: the recurrent
and attention layers and text encoders, ``CosineWithWarmup``, the cross
models and the retrieval towers and dual encoders.

Inputs from a numpy seed; weights drawn with numpy over JAX's parameter
shapes and loaded into the port through ``from_jax_variables(variables,
model)``, strictly; dropout off on both sides (flax's ``nn.Dropout``
made the identity, the port's rates set to 0) or eval mode.  Tolerances:

* ``RnnEncoder`` (GRU bi- and unidirectional, RNN, LSTM; 2 layers),
  ``IntraAttention``, ``SelfAttention``, ``PositionalEncoding``, the
  ``ConvBlock`` pools and ``CosineWithWarmup``: 1e-5; the bidirectional
  GRU's gradients 1e-4;
* ``CrossCDur`` and ``CrossCnn8Rnn`` at full width on 1 s clips: 1e-4
  relative RMS; one f32 train-mode step's gradients (batch statistics)
  within 1e-4 relative RMS after the conv trunk and 2e-2 in it;
* ``Cnn14``, ``ResNet38`` and ``WavegramLogmelCnn14`` at full width on 1 s
  clips, batch 2, and the AST at its narrow test width: 1e-4 relative
  RMS; ``AudioTextClip`` / ``AudioSingleTextClip`` 1e-4 with their
  ``logit_scale``; ``grad_scale``'s gradient exactly ``alpha·g``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_text_towers import (
    jax_variables,
    np_tree,
    rel_rms,
    to_port,
    torch_batch,
)
from texttoaudiogrounding_tpu.models import cross_models as jcross
from texttoaudiogrounding_tpu.models import layers as jlayers
from texttoaudiogrounding_tpu.models import pretrained_text as jpt
from texttoaudiogrounding_tpu.models import retrieval as jret
from texttoaudiogrounding_tpu.models import retrieval_towers as jtowers
from texttoaudiogrounding_tpu.models import text_encoder as jtext
from texttoaudiogrounding_tpu.training import optim as joptim
from texttoaudiogrounding_tpu_torch.models import cross_models, layers
from texttoaudiogrounding_tpu_torch.models import pretrained_text as pt
from texttoaudiogrounding_tpu_torch.models import retrieval
from texttoaudiogrounding_tpu_torch.models import retrieval_towers
from texttoaudiogrounding_tpu_torch.models import text_encoder
from texttoaudiogrounding_tpu_torch.ops.kernels import gru
from texttoaudiogrounding_tpu_torch.training import optim
from texttoaudiogrounding_tpu_torch.weights import from_jax_variables

_VOCAB = 50


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text_batch(rng) -> dict:
    return {"text": rng.integers(1, _VOCAB, size=(3, 6)),
            "text_len": np.array([6, 3, 1])}


def _clips(rng, n: int = 32000, b: int = 2) -> dict:
    return {"waveform": (rng.normal(size=(b, n)) * 0.1).astype(np.float32),
            "waveform_len": np.array([n, n // 2][:b]),
            "text": rng.integers(1, _VOCAB, size=(b, 4)),
            "text_len": np.array([4, 2][:b])}


# --------------------------------------------------- layers and encoders
_ENCODERS = {
    "gru_bi": ("RnnEncoder", (_VOCAB, 8, 6, 2),
               {"bidirectional": True}),
    "gru_uni": ("RnnEncoder", (_VOCAB, 8, 6, 2), {}),
    "rnn_bi": ("RnnEncoder", (_VOCAB, 8, 6, 2),
               {"bidirectional": True, "rnn_type": "RNN"}),
    "lstm_bi": ("RnnEncoder", (_VOCAB, 8, 6, 2),
                {"bidirectional": True, "rnn_type": "LSTM"}),
    "lstm_uni": ("RnnEncoder", (_VOCAB, 8, 6, 2), {"rnn_type": "LSTM"}),
    "intra_attention": ("IntraAttention", (_VOCAB, 8, 2), {}),
    "self_attention": ("SelfAttention", (_VOCAB, 8, 2), {}),
}


@pytest.mark.parametrize("case", list(_ENCODERS))
def test_text_encoder_matches_jax(case):
    name, args, kw = _ENCODERS[case]
    batch = _text_batch(np.random.default_rng(2))
    jm = getattr(jtext, name)(*args, **kw)
    variables = jax_variables(jm, batch, 3)
    ref = jax.jit(jm.apply)(variables, batch)
    model = to_port(getattr(text_encoder, name)(*args, **kw), variables)
    with torch.no_grad():
        got = model(torch_batch(batch))
    for key in ("seq_emb", "token_emb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_bidirectional_gru_gradients_match_jax():
    """``RnnEncoder``'s bidirectional GRU through ``bigru_trainable``: the
    gradients of every parameter of a cotangent-weighted sum, 1e-4."""
    rng = np.random.default_rng(4)
    batch = _text_batch(rng)
    jm = jtext.RnnEncoder(_VOCAB, 8, 6, 2, bidirectional=True)
    variables = jax_variables(jm, batch, 5)
    cot = rng.normal(size=(3, 6, 12)).astype(np.float32)

    def loss(params):
        out = jm.apply({"params": params}, batch)
        return jnp.sum(out["token_emb"] * cot) + jnp.sum(out["seq_emb"])
    jgrads = {"params": jax.jit(jax.grad(loss))(variables["params"])}
    model = to_port(text_encoder.RnnEncoder(_VOCAB, 8, 6, 2,
                                            bidirectional=True), variables)
    out = model(torch_batch(batch))
    (torch.sum(out["token_emb"] * torch.from_numpy(cot))
     + out["seq_emb"].sum()).backward()
    want = from_jax_variables(jgrads, model)
    for name, p in model.named_parameters():
        if name.endswith("bias_hh_l0") or name.endswith("bias_hh_l0_reverse"):
            # only the n third is a JAX leaf; the r/z thirds are detached
            np.testing.assert_allclose(p.grad.numpy()[-6:],
                                       want[name].numpy()[-6:],
                                       rtol=1e-4, atol=1e-4)
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_positional_encoding_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 9, 10)).astype(np.float32)
    ref = jlayers.PositionalEncoding(0.2).apply({}, x, train=False)
    got = layers.PositionalEncoding(0.2).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pool_type", ["avg", "max", "avg+max"])
def test_conv_block_pool_types_match_jax(pool_type):
    x = np.random.default_rng(7).normal(size=(2, 9, 8, 3)).astype(np.float32)
    jm = jlayers.ConvBlock(16)
    kw = dict(bn_train=False, pool_size=(2, 2), pool_type=pool_type)
    variables = np_tree(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x, **kw)), 8)
    ref = jm.apply(variables, x, **kw)
    block = to_port(layers.ConvBlock(3, 16), variables)
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x), (2, 2), pool_type=pool_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    served = layers.ConvBlock(3, 16, conv_mode="int8")
    with pytest.raises(ValueError, match="avg\\+max"):
        served.eval()(torch.from_numpy(x), (2, 2),
                      pool_type=pool_type if pool_type != "avg+max"
                      else "max")


def test_cosine_with_warmup_matches_jax():
    ours = optim.CosineWithWarmup(1e-3, 5, 40, final_lr_ratio=0.1)
    theirs = joptim.CosineWithWarmup(1e-3, 5, 40, final_lr_ratio=0.1)
    assert [ours(i) for i in range(50)] == [theirs(i) for i in range(50)]


def test_gru_routes_by_shape():
    """Row 13 at text widths: the cluster designs take H <= 256; word2vec's
    H = 300 goes to the first design (``csrc/gru.cu``), and so does
    H = 302 (not a multiple of 4, and no cluster of <= 16 CTAs of <= 16
    units), which the first design runs padded to 304 with zero units,
    as the JAX package runs it."""
    assert gru.route(80, 256) == {"forward": "cluster",
                                  "backward": "cluster"}
    assert gru.route(80, 300) == {"forward": "per_step",
                                  "backward": "per_step"}
    assert gru.route(80, 300, variant="v2")["backward"] == "per_step"
    assert gru.route(80, 302)["forward"] == "per_step"
    for part in ("forward", "backward", "walk"):
        assert gru.per_step_plan(80, 302, part) == {"h": 304,
                                                    "groups": [(0, 80)]}
    rng = np.random.default_rng(3)
    proj = torch.from_numpy(rng.normal(size=(3, 4, 906)).astype(np.float32))
    wh = torch.from_numpy(rng.normal(0, 0.05, (2, 302, 906)).astype(
        np.float32))
    bn = torch.from_numpy(rng.normal(0, 0.05, (2, 302)).astype(np.float32))
    ys = gru.run_per_step_plan(gru.per_step_plan(2, 302, "forward"),
                               lambda *a: (gru.gru_forward_plain(*a),),
                               (proj,), (wh, bn), 302, 1)[0]
    torch.testing.assert_close(ys, gru.gru_forward_plain(proj, wh, bn),
                               rtol=1e-6, atol=1e-6)


def test_gru_route_of_a_forward_ignores_the_backward_limit():
    """At H = 300 and 175 rows a direction the first design's bf16 forward
    fits in shared memory and its backward does not: choosing the forward's
    design (the bf16 serving call) does not raise."""
    assert gru.route(175, 300, torch.bfloat16)["forward"] == "per_step"


# -------------------------------------------------------------- cross
def _cross(kind: str):
    jtxt, txt = jtext.EmbeddingAgg(_VOCAB, 16), text_encoder.EmbeddingAgg(
        _VOCAB, 16)
    if kind == "CrossCDur":
        return (jcross.CrossCDur(32000, jtxt),
                cross_models.CrossCDur(32000, txt, device="cpu"))
    return (jcross.CrossCnn8Rnn(32000, jtxt),
            cross_models.CrossCnn8Rnn(32000, txt, device="cpu"))


@pytest.fixture(scope="module")
def cross_setups():
    batch = _clips(np.random.default_rng(9))
    out = {}
    for seed, kind in enumerate(("CrossCDur", "CrossCnn8Rnn"), start=10):
        jm, model = _cross(kind)
        variables = jax_variables(jm, batch, seed)
        out[kind] = (jm, to_port(model, variables), variables)
    return batch, out


@pytest.mark.parametrize("kind", ["CrossCDur", "CrossCnn8Rnn"])
def test_cross_model_forward_matches_jax(cross_setups, kind):
    batch, setups = cross_setups
    jm, model, variables = setups[kind]
    ref = jax.jit(jm.apply)(variables, batch)
    with torch.no_grad():
        got = model(torch_batch(batch))
    assert got["frame_sim"].shape == ref["frame_sim"].shape
    assert rel_rms(got["frame_sim"].numpy(), ref["frame_sim"]) <= 1e-4
    np.testing.assert_array_equal(got["length"].numpy(), ref["length"])


# the conv trunk, and the text tower, whose gradient comes back through
# every block's fc_text
_TRUNK = ("conv_block", "block", "bn0", "text_encoder")


@pytest.mark.parametrize("kind", ["CrossCDur", "CrossCnn8Rnn"])
def test_cross_model_train_step_grads_match_jax(cross_setups, kind,
                                                monkeypatch):
    batch, setups = cross_setups
    jm, model, variables = setups[kind]
    cot = np.random.default_rng(12).normal(
        size=np.asarray(jax.eval_shape(lambda: jm.apply(
            variables, batch)["frame_sim"]).shape)).astype(np.float32)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)

    def loss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, batch,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(out["frame_sim"] * cot)
    jgrads = jax.jit(jax.grad(loss))(variables["params"])
    model.dropout = 0.0 if kind == "CrossCDur" else (0.0, 0.0)
    to_port(model, variables).train()        # fresh running statistics
    try:
        out = model(torch_batch(batch))
        torch.sum(out["frame_sim"] * torch.from_numpy(cot)).backward()
    finally:
        model.eval()
    want = from_jax_variables({"params": jgrads,
                               "batch_stats": variables["batch_stats"]},
                              model)
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        if "bias_hh" in name:
            h = p.shape[0] // 3
            got, ref = p.grad[2 * h:], want[name][2 * h:]
        else:
            got, ref = p.grad, want[name]
        limit = 2e-2 if name.startswith(_TRUNK) else 1e-4
        assert rel_rms(got.numpy(), ref.numpy()) <= limit, name


# ----------------------------------------------------------- retrieval
_TOWERS = {
    "Cnn14": (jret.Cnn14, retrieval.Cnn14, {}),
    "ResNet38": (jtowers.ResNet38, retrieval_towers.ResNet38, {}),
    "WavegramLogmelCnn14": (jtowers.WavegramLogmelCnn14,
                            retrieval_towers.WavegramLogmelCnn14, {}),
    "AST": (jtowers.AudioSpectrogramTransformer,
            retrieval_towers.AudioSpectrogramTransformer,
            dict(hidden_size=64, num_layers=2, num_heads=2, mlp_dim=128,
                 embed_dim=64)),
}


@pytest.mark.parametrize("name", list(_TOWERS))
def test_retrieval_tower_matches_jax(name):
    jcls, cls, kw = _TOWERS[name]
    batch = _clips(np.random.default_rng(13))
    jm = jcls(**kw)
    variables = jax_variables(jm, batch, 14)
    ref = jax.jit(jm.apply)(variables, batch)
    extra = {"input_tdim": 101} if name == "AST" else {}
    model = to_port(cls(**kw, **extra, device="cpu"), variables)
    with torch.no_grad():
        got = model(torch_batch(batch))
    for key in ("clip_emb", "time_emb"):
        assert got[key].shape == ref[key].shape, key
        assert rel_rms(got[key].numpy(), ref[key]) <= 1e-4, key
    np.testing.assert_array_equal(got["length"].numpy(), ref["length"])


def _tiny_bert(mod):
    return mod.TextTowerConfig(vocab_size=_VOCAB, hidden_size=32,
                               num_layers=1, num_heads=2,
                               intermediate_size=64,
                               max_position_embeddings=16)


@pytest.fixture(scope="module")
def clip_setup():
    """(batch of 2 clips x 2 captions, the port's ``AudioTextClip(Cnn14,
    RetrievalBert)`` on JAX's weights, its JAX ``audio_emb``,
    ``text_emb`` and ``logit_scale``: one JAX compile for both tests)."""
    rng = np.random.default_rng(15)
    n = 16000
    ids = rng.integers(1, _VOCAB, size=(2, 2, 5))
    mask = np.ones((2, 2, 5), np.int64)
    mask[1, 0, 3:] = 0
    batch = {"waveform": (rng.normal(size=(2, n)) * 0.1).astype(np.float32),
             "waveform_len": np.array([n, 12000]), "input_ids": ids,
             "attention_mask": mask}
    jm = jret.AudioTextClip(audio_encoder=jret.Cnn14(),
                            text_encoder=jret.RetrievalBert(_tiny_bert(jpt)),
                            audio_dim=2048, text_dim=32, shared_dim=16)
    variables = jax_variables(jm, {**batch, "num_captions": 2}, 16)
    ref = jax.jit(lambda v, b: jm.apply(v, {**b, "num_captions": 2}))(
        variables, batch)
    model = to_port(retrieval.AudioTextClip(
        retrieval.Cnn14(device="cpu"),
        retrieval.RetrievalBert(_tiny_bert(pt), device="cpu"),
        2048, 32, 16, device="cpu"), variables)
    return batch, model, jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("single", [False, True])
def test_audio_text_clip_matches_jax(clip_setup, single):
    """The port's dual encoders against JAX's ``AudioTextClip`` on the
    same weights (``AudioSingleTextClip``, over the same towers, on each
    clip's first caption, whose embedding JAX's two-caption forward
    holds), and their ``logit_scale``."""
    batch, model, ref = clip_setup
    text = ref["text_emb"]
    feed = torch_batch(batch)
    if single:
        single_model = retrieval.AudioSingleTextClip(
            model.audio_encoder, model.text_encoder, 2048, 32, 16,
            device="cpu")
        single_model.load_state_dict(model.state_dict())
        model = single_model.eval()
        feed = {k: v[:, 0] if k in ("input_ids", "attention_mask") else v
                for k, v in feed.items()}
        text = text[:, 0]
    else:
        feed["num_captions"] = 2
    with torch.no_grad():
        got = model(feed)
    assert got["text_emb"].shape == text.shape
    assert rel_rms(got["audio_emb"].numpy(), ref["audio_emb"]) <= 1e-4
    assert rel_rms(got["text_emb"].numpy(), text) <= 1e-4
    np.testing.assert_allclose(float(got["logit_scale"]),
                               float(ref["logit_scale"]), rtol=1e-6)
    fresh = type(model)(torch.nn.Identity(), torch.nn.Identity(), 4, 4, 2,
                        device="cpu")
    np.testing.assert_allclose(float(fresh.logit_scale.detach().exp()),
                               1 / 0.07, rtol=1e-6)


def test_grad_scale_gradient_is_alpha_g():
    x = torch.randn(4, 5, requires_grad=True)
    g = torch.randn(4, 5)
    y = retrieval.grad_scale(x, 0.5)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    y.backward(g)
    torch.testing.assert_close(x.grad, 0.5 * g, rtol=0, atol=0)
    jgrad = jax.grad(lambda a: jnp.sum(jret.grad_scale(a, 0.5) * g.numpy()))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jgrad))
