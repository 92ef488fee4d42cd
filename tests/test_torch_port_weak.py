"""The port's phrase-level WSTAG training against the JAX package.

Same numpy inputs and, through ``from_jax_variables``, the same weights go
through both packages (dropout the identity on both sides for a train
step).  Tolerances:

* the four masked MIL poolings and the ``linear_softmax`` gradient: rtol
  1e-6 (the same f32 operations; zero-length rows nan or -inf in both);
* the pairwise match functions ``[B, T, D] x [B, N, D] -> [B, N, T]``:
  rtol 1e-6, atol 1e-7;
* ``MultiTextBiEncoder``'s f32 forward (``frame_sim [B, T, N]`` and
  ``clip_sim [B, N]``) at the full Cnn8Rnn width on 1 s clips: 1e-4
  relative RMS, as the strong model's audio embedding is held; so too
  with ``upsample=True`` and with a token-level ``DotProduct`` under a
  ``CrossAttentionGating`` cross encoder;
* one whole f32 WSTAG train step (``ClipBceLoss`` through
  ``weak_output_transform``), the port's GRU on the hoisted ``v2``
  backward against the JAX runner's step on the CPU (its GRU a
  ``lax.scan`` under ``jax.grad``; ``tests/test_torch_port_gru.py`` holds
  the v2 / v3 walks to the JAX kernels in interpret mode): loss rtol 1e-5
  (measured 1.7e-7) and running statistics 1e-5, and each conv-trunk
  gradient within twice the larger of the two packages' own change when
  the waveform is scaled by 1 + 1e-6, measured in the test parameter by
  parameter.  The step is that ill-conditioned: batch 2, 1 s clips,
  train-mode BN.  Under the scaling the port's trunk gradients move by
  1.5-1.9e-2 relative RMS and JAX's by 0.6-1.0e-2, and the port-vs-JAX
  gap reads 1.5-2.0e-2 (0.50-0.56 of the bound, on an 8-core AMD EPYC
  without AMX; 3.9e-3 on the CPU where the test was written).  The
  largest discrete event is one ReLU at fc1 (clip 0, frame 14, unit 322)
  whose input is +3.3e-7 in the port and -8.3e-6 in JAX.  The rule is the
  same on both sides; the last-bit differences of the trunk put it on
  either side of 0, and the scaling moves the port's to JAX's side.  It
  moves fc1's and block 4's bn2 gradients by 5e-3.  So the gradients
  after the trunk are held twice: within the larger of 1e-4 and twice the
  packages' own change on the step itself (fc1 reads 5.7e-3 against an
  own change of 5.7e-3, the GRU and text side 0.2-3.9e-6), and at 1e-4
  (measured at most 3.5e-7) on a second port step run on from JAX's
  trunk output (block 4's output replaced by it, a forward hook), whose
  loss is held at rtol 1e-5 too.  The JAX step
  runs eagerly: under ``jax.jit`` one ReLU at fc1 flips sign, and fc1's
  kernel gradient moves by 5.7e-3 from the eager step's;
* ``AudioSamplePhrasesDataset``: items identical to the JAX class's for
  every negative-sampling strategy at the same seed and ``reseed`` salt;
* the NaN guard + clipping + Adam against ``optax``: 2e-7 absolute on the
  parameters, which still move;
* ``WeakPhraseRunner.train`` end to end: the saved model goes through
  ``import_biencoder`` into the JAX model and gives ``frame_sim`` and
  ``clip_sim`` within 1e-4.
"""

import json
import pickle

import flax.linen as fnn
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tests.synthetic import make_grounding_data, make_vocab
from tests.test_torch_port_align import jax_variables
from tests.test_torch_port_train import _rel_rms
from texttoaudiogrounding_tpu.data.collate import TextCollate as JCollate
from texttoaudiogrounding_tpu.data.datasets import (
    AudioSamplePhrasesDataset as JPhrases,
)
from texttoaudiogrounding_tpu.data.tokenizer import DictTokenizer as JTok
from texttoaudiogrounding_tpu.losses import ClipBceLoss as JClipBce
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.audio_text_model import (
    MultiTextBiEncoder as JMultiText,
)
from texttoaudiogrounding_tpu.models.cross_encoder import (
    CrossAttentionGating as JCrossGating,
)
from texttoaudiogrounding_tpu.models.match import DotProduct as JDotProduct
from texttoaudiogrounding_tpu.models.match import ExpNegL2 as JExpNegL2
from texttoaudiogrounding_tpu.ops import masking as jmasking
from texttoaudiogrounding_tpu.training import optim as joptim
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    WeakPhraseRunner as JWeakPhraseRunner,
)
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    weak_output_transform as j_output_transform,
)
from texttoaudiogrounding_tpu.training.torch_import import import_biencoder
from texttoaudiogrounding_tpu_torch import from_jax_variables
from texttoaudiogrounding_tpu_torch.data.collate import TextCollate
from texttoaudiogrounding_tpu_torch.data.datasets import (
    AudioSamplePhrasesDataset,
)
from texttoaudiogrounding_tpu_torch.data.loader import build_loader, to_device
from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
from texttoaudiogrounding_tpu_torch.losses import ClipBceLoss
from texttoaudiogrounding_tpu_torch.models import (
    Cnn8Rnn,
    CrossAttentionGating,
    DotProduct,
    EmbeddingAgg,
    ExpNegL2,
    MultiTextBiEncoder,
)
from texttoaudiogrounding_tpu_torch.ops import masking
from texttoaudiogrounding_tpu_torch.ops.kernels import gru
from texttoaudiogrounding_tpu_torch.training import optim
from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
    WeakPhraseRunner,
    weak_output_transform,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate, resolve

_VOCAB, _EMBED, _N = 100, 64, 4
_POOLINGS = ("linear_softmax", "max", "mean", "exp_softmax")


# ----------------------------------------------------------------- poolings
@pytest.mark.parametrize("pooling", _POOLINGS)
def test_masked_pooling_matches_jax(pooling):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.05, 1.0, (3, 7, 4)).astype(np.float32)
    lens = np.array([7, 3, 0], np.int64)
    ref = np.asarray(getattr(jmasking, f"{pooling}_with_lens")(
        jnp.asarray(x), jnp.asarray(lens)))
    got = masking.POOLINGS[pooling](torch.from_numpy(x),
                                    torch.from_numpy(lens)).numpy()
    assert not np.isfinite(ref[2]).any() and not np.isfinite(got[2]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_linear_softmax_gradient_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0.05, 1.0, (3, 9, 5)).astype(np.float32)
    lens = np.array([9, 4, 1], np.int64)
    g = rng.normal(size=(3, 5)).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jmasking.linear_softmax_with_lens(
        v, jnp.asarray(lens)) * g))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (masking.linear_softmax_with_lens(tx, torch.from_numpy(lens))
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert not tx.grad[1, 4:].any()                 # padded frames: none


@pytest.mark.parametrize("match", ["DotProduct", "ExpNegL2"])
def test_pairwise_match_matches_jax(match):
    rng = np.random.default_rng(3)
    audio = rng.normal(size=(2, 6, 8)).astype(np.float32)
    text = rng.normal(size=(2, 3, 8)).astype(np.float32)
    jfn = {"DotProduct": JDotProduct(), "ExpNegL2": JExpNegL2()}[match]
    fn = {"DotProduct": DotProduct(), "ExpNegL2": ExpNegL2()}[match]
    ref = np.asarray(jfn.pairwise(jnp.asarray(audio), jnp.asarray(text)))
    got = fn.pairwise(torch.from_numpy(audio), torch.from_numpy(text))
    assert got.shape == (2, 3, 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------------- model
def _batch():
    rng = np.random.default_rng(11)
    text = rng.integers(2, _VOCAB, (2, _N, 3)).astype(np.int32)
    text_len = np.array([[3, 2, 1, 3], [2, 3, 3, 1]], np.int32)
    for b in range(2):
        for n in range(_N):
            text[b, n, text_len[b, n]:] = 0
    return {
        "waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(np.float32),
        "waveform_len": np.array([32000, 21000], np.int32),
        "text": text, "text_len": text_len,
        "label": np.array([[1, 1, 0, 0], [1, 0, 0, 0]], np.float32),
    }


# (match, pooling, text embedding width, add_proj): the second case has no
# projections (text width = audio width = 512)
_MODELS = {"dot_linear_softmax": ("DotProduct", "linear_softmax", _EMBED,
                                  True),
           "expnegl2_exp_softmax": ("ExpNegL2", "exp_softmax", 512, False)}


def _jax_model(match, pooling, embed, add_proj, vocab=_VOCAB):
    return JMultiText(
        audio_encoder=JCnn8Rnn(sample_rate=32000),
        text_encoder=JEmbeddingAgg(vocab_size=vocab, embed_dim=embed),
        match_fn={"DotProduct": JDotProduct,
                  "ExpNegL2": JExpNegL2}[match](),
        shared_dim=_EMBED, add_proj=add_proj, pooling=pooling)


def _port_model(match, pooling, embed, add_proj, **audio):
    return MultiTextBiEncoder(
        Cnn8Rnn(**audio), EmbeddingAgg(_VOCAB, embed),
        {"DotProduct": DotProduct, "ExpNegL2": ExpNegL2}[match](),
        shared_dim=_EMBED, add_proj=add_proj, pooling=pooling, device="cpu")


@pytest.mark.parametrize("case", sorted(_MODELS))
def test_multitext_forward_matches_jax(case):
    batch = _batch()
    jmodel = _jax_model(*_MODELS[case])
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(1)}, batch, train=False))
    ref = jmodel.apply(variables, batch, train=False)
    model = _port_model(*_MODELS[case])
    model.load_state_dict(from_jax_variables(variables, model))  # strict
    assert model.needs_proj == (case == "dot_linear_softmax")
    with torch.no_grad():
        out = model(to_device(batch, torch.device("cpu")))
    assert out["frame_sim"].shape == ref["frame_sim"].shape == (2, 25, _N)
    assert out["clip_sim"].shape == (2, _N)
    np.testing.assert_array_equal(out["length"].numpy(),
                                  np.asarray(ref["length"]))
    for key in ("frame_sim", "clip_sim"):
        rel = _rel_rms(out[key].numpy(), np.asarray(ref[key]))
        assert rel <= 1e-4, (key, rel)


def _is_trunk(name: str) -> bool:
    return "conv_block" in name or "bn0" in name


def _scaled(batch: dict, factor: float) -> dict:
    return dict(batch, waveform=(batch["waveform"] * np.float32(factor))
                .astype(np.float32))


def _jax_wstag_step(jmodel, variables, batch):
    """The eager JAX step, dropout the identity: (loss, the port-named
    gradients and mutated running statistics, block 4's output)."""
    taken = {}

    def take(f, args, kwargs, ctx):
        out = f(*args, **kwargs)
        if ctx.method_name == "__call__" and ctx.module.name == \
                "conv_block4":
            taken["trunk"] = out
        return out

    def loss_of(params):
        with fnn.intercept_methods(take):
            out, mut = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch, train=True, mutable=["batch_stats"])
        return JClipBce()(j_output_transform(out, batch)), (
            mut, jax.lax.stop_gradient(taken["trunk"]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        (loss, (mut, trunk)), grads = jax.value_and_grad(
            loss_of, has_aux=True)(variables["params"])
    ref = from_jax_variables(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": mut["batch_stats"]}),
        _port_model(*_MODELS["dot_linear_softmax"]))
    return float(loss), ref, np.array(trunk, np.float32)


def _port_wstag_step(variables, batch, trunk=None):
    """The port's step on the ``v2`` backward; with ``trunk`` block 4's
    output is replaced by it."""
    model = _port_model(*_MODELS["dot_linear_softmax"], dropout=(0.0, 0.0),
                        gru_bwd="v2")
    model.load_state_dict(from_jax_variables(variables, model))
    model.train()
    if trunk is not None:
        model.audio_encoder.conv_block4.register_forward_hook(
            lambda mod, args, out: torch.from_numpy(trunk))
    tb = to_device(batch, torch.device("cpu"))
    loss = ClipBceLoss()(weak_output_transform(model(tb), tb))
    loss.backward()
    return model, loss.item()


def test_whole_wstag_train_step_matches_the_jax_runner():
    batch = _batch()
    jmodel = _jax_model(*_MODELS["dot_linear_softmax"])
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    jloss, ref, jtrunk = _jax_wstag_step(jmodel, variables, batch)
    _, ref_s, _ = _jax_wstag_step(jmodel, variables, _scaled(batch, 1 + 1e-6))
    gru.launches["gru_bwd_v2"] = 0
    model, loss = _port_wstag_step(variables, batch)
    model_s, _ = _port_wstag_step(variables, _scaled(batch, 1 + 1e-6))
    assert loss == pytest.approx(jloss, rel=1e-5)
    grads_s = dict(model_s.named_parameters())
    params = list(model.named_parameters())
    assert sum(_is_trunk(n) for n, _ in params) == 26
    for name, p in params:
        own = max(_rel_rms(grads_s[name].grad.numpy(), p.grad.numpy()),
                  _rel_rms(ref_s[name].numpy(), ref[name].numpy()))
        rel = _rel_rms(p.grad.numpy(), ref[name].numpy())
        bound = 2 * own if _is_trunk(name) else max(2 * own, 1e-4)
        assert rel <= bound, (name, rel, own)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    pinned, loss = _port_wstag_step(variables, batch, jtrunk)
    assert loss == pytest.approx(jloss, rel=1e-5)
    rest = [(n, p) for n, p in pinned.named_parameters() if not _is_trunk(n)]
    assert len(rest) == 15
    for name, p in rest:
        rel = _rel_rms(p.grad.numpy(), ref[name].numpy())
        assert rel <= 1e-4, (name, rel)
    assert gru.launches["gru_bwd_v2"] == 0      # the CPU runs the plain walk


def test_multitext_rejects_what_is_not_ported():
    """Once the two refusals of what was not ported; now parity: with
    ``upsample=True`` (``frame_sim`` interpolated to 100 frames, the
    length ×4), and with a token-level ``DotProduct`` under a
    ``CrossAttentionGating`` cross encoder (the broadcast branch), each
    within 1e-4 relative RMS of the JAX model; an unknown pooling still
    raises."""
    batch = _batch()
    cases = {
        "upsample": (JMultiText(
            audio_encoder=JCnn8Rnn(sample_rate=32000),
            text_encoder=JEmbeddingAgg(vocab_size=_VOCAB, embed_dim=_EMBED),
            match_fn=JDotProduct(), shared_dim=_EMBED, add_proj=True,
            upsample=True), MultiTextBiEncoder(
                Cnn8Rnn(), EmbeddingAgg(_VOCAB, _EMBED), DotProduct(),
                shared_dim=_EMBED, add_proj=True, upsample=True,
                device="cpu")),
        "cross_token": (JMultiText(
            audio_encoder=JCnn8Rnn(sample_rate=32000),
            text_encoder=JEmbeddingAgg(vocab_size=_VOCAB, embed_dim=512),
            match_fn=JDotProduct(text_level="token"),
            cross_encoder=JCrossGating(embed_dim=512)), MultiTextBiEncoder(
                Cnn8Rnn(), EmbeddingAgg(_VOCAB, 512),
                DotProduct(text_level="token"),
                cross_encoder=CrossAttentionGating(512), device="cpu")),
    }
    for name, (jmodel, model) in cases.items():
        variables = jax_variables(jmodel, batch, model, seed=4)
        ref = jmodel.apply(variables, batch, train=False)
        with torch.no_grad():
            out = model(to_device(batch, torch.device("cpu")))
        t = 100 if name == "upsample" else 25
        assert out["frame_sim"].shape == ref["frame_sim"].shape == (2, t,
                                                                    _N)
        np.testing.assert_array_equal(out["length"].numpy(),
                                      np.asarray(ref["length"]))
        for key in ("frame_sim", "clip_sim"):
            rel = _rel_rms(out[key].numpy(), np.asarray(ref[key]))
            assert rel <= 1e-4, (name, key, rel)
    with pytest.raises(ValueError, match="pooling"):
        MultiTextBiEncoder(Cnn8Rnn(), EmbeddingAgg(_VOCAB, _EMBED),
                           DotProduct(), pooling="attention", device="cpu")


# ------------------------------------------------------------------ dataset
_PHRASES = [f"w{a} w{b}" for a in range(2, 8) for b in (20, 30, 40, 50)]
_PHRASES += ["w9 w10 w11 w12 w13"]          # dropped by max_phrase_length 4


@pytest.fixture(scope="module")
def phrase_data(tmp_path_factory):
    """Six 1.5 s clips, captions of 1-3 phrases out of 25, a phrase
    embedding (.pkl and .h5), a negative pool and two cluster maps (the
    second with a positive in every cluster)."""
    root = tmp_path_factory.mktemp("wstag_items")
    make_grounding_data(root, num_audio=6, duration=1.5, seed=4)
    rng = np.random.default_rng(8)
    label = [{"audiocap_id": i, "audio_id": f"Yaudio{i:04d}",
              "tokens": "", "phrases": [
                  _PHRASES[k] for k in rng.choice(len(_PHRASES),
                                                  int(rng.integers(1, 4)),
                                                  replace=False)]}
             for i in range(6)]
    label[0]["phrases"].append(_PHRASES[-1])
    (root / "caps.json").write_text(json.dumps(label))
    emb = {p: rng.normal(size=16).astype(np.float32) for p in _PHRASES}
    with open(root / "emb.pkl", "wb") as f:
        pickle.dump(emb, f)
    with h5py.File(root / "emb.h5", "w") as hf:
        for p, v in emb.items():
            hf[p] = v
    (root / "pool.txt").write_text("\n".join(_PHRASES[::-1]) + "\n")
    (root / "clusters.json").write_text(json.dumps(
        {str(i): _PHRASES[i::5] for i in range(5)}))
    (root / "one_cluster.json").write_text(json.dumps({"0": _PHRASES}))
    (root / "words.json").write_text(json.dumps(
        [{"tokens": " ".join(_PHRASES)}]))
    make_vocab(root / "words.json", root / "vocab.pkl")
    return root


_STRATEGIES = {
    "random": {"neg_samp_stratg": "random"},
    "random_fix_neg": {"neg_samp_stratg": "random", "fix_neg": True},
    "similarity_pkl_pool": {"neg_samp_stratg": "similarity",
                            "phrase_embed": "emb.pkl", "sim_threshold": 0.5,
                            "negative_pool": "pool.txt"},
    "similarity_h5": {"neg_samp_stratg": "similarity",
                      "phrase_embed": "emb.h5", "sim_threshold": 0.3},
    "clustering": {"neg_samp_stratg": "clustering",
                   "cluster_map": "clusters.json"},
    "clustering_degenerate": {"neg_samp_stratg": "clustering",
                              "cluster_map": "one_cluster.json"},
}


def _phrase_args(root, case):
    args = {"audio": str(root / "waveform_fp.csv"),
            "label": str(root / "caps.json"), "phrase_num": 6,
            "fix_neg": False, "max_phrase_length": 4,
            "max_audio_length": 1.0, "seed": 5}
    for key, value in _STRATEGIES[case].items():
        args[key] = (str(root / value)
                     if key in ("phrase_embed", "negative_pool",
                                "cluster_map") else value)
    return args


@pytest.mark.parametrize("case", sorted(_STRATEGIES))
def test_sample_phrases_dataset_matches_jax(phrase_data, case):
    args = _phrase_args(phrase_data, case)
    ds, jds = AudioSamplePhrasesDataset(**args), JPhrases(**args)
    assert len(ds) == len(jds) == 6
    for salt in (None, 1, 2, 1):
        if salt is not None:
            ds.reseed(salt)
            jds.reseed(salt)
        for i in range(len(ds)):
            it, jit = ds[i], jds[i]
            assert [str(p) for p in it["phrases"]] == \
                [str(p) for p in jit["phrases"]], (salt, i)
            assert len(it["phrases"]) == 6
            assert "w9 w10 w11 w12 w13" not in it["phrases"]
            np.testing.assert_array_equal(it["label"], jit["label"])
            np.testing.assert_array_equal(it["waveform"], jit["waveform"])
            assert it["waveform"].shape == (32000,)          # cropped


def test_loader_batches_are_the_same_with_worker_processes(phrase_data):
    """Per-batch salts make the batches of a loader with worker processes
    (each with its own copy of the dataset) those of the dataset reseeded
    with ``seed + epoch * 1000003 + i`` before batch ``i``."""
    args = _phrase_args(phrase_data, "random")
    collate = TextCollate(DictTokenizer(str(phrase_data / "vocab.pkl")),
                          text_key="phrases", pad_keys=["waveform"])
    loader = build_loader(AudioSamplePhrasesDataset(**args), collate, seed=3,
                          batch_size=2, num_workers=2,
                          multiprocessing_context="spawn")
    loader.set_epoch(2)
    got = [b["text"] for b in loader]
    ref_ds = AudioSamplePhrasesDataset(**args)
    for i, tokens in enumerate(got):
        ref_ds.reseed(3 + 2 * 1000003 + i)
        ref = collate([ref_ds[j] for j in (2 * i, 2 * i + 1)])
        np.testing.assert_array_equal(tokens, ref["text"])
    # in this process: one stream per epoch, reseeded by set_epoch
    inline = build_loader(AudioSamplePhrasesDataset(**args), collate, seed=3,
                          batch_size=2)
    inline.set_epoch(2)
    ref_ds.reseed(2)
    for i, batch in enumerate(inline):
        ref = collate([ref_ds[j] for j in (2 * i, 2 * i + 1)])
        np.testing.assert_array_equal(batch["text"], ref["text"])


# -------------------------------------------------------------- the runner
def test_nan_guard_step_matches_optax():
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,)]
    init = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    good = [rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]
    bad = [np.full(s, np.nan, np.float32) for s in shapes]
    tx = joptim.build_optimizer({"type": "Adam", "args": {"lr": 1e-3}},
                                max_grad_norm=1.0)
    jparams = [jnp.asarray(a) for a in init]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = optim.Optimizer({"type": "Adam", "args": {"lr": 1e-3}}, params,
                          max_grad_norm=1.0)
    runner = WeakPhraseRunner(device="cpu")
    for loss, gs in ((0.7, good), (np.nan, bad)):
        jgs = JWeakPhraseRunner.post_grad_hook(
            None, jnp.float32(loss), [jnp.asarray(g) for g in gs])
        updates, state = tx.update(jgs, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        before = [p.detach().clone() for p in params]
        runner.post_grad_hook(torch.tensor(loss, dtype=torch.float32),
                              [p.grad for p in params])
        opt.step()
        for p, b, jp in zip(params, before, jparams):
            assert torch.isfinite(p).all()
            assert not torch.equal(p.detach(), b)    # the step still moves
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       rtol=0, atol=2e-7)
    assert opt.inner.state[params[0]]["step"] == 2


@pytest.fixture(scope="module")
def wstag_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("wstag_runner")
    _, label_json, _ = make_grounding_data(
        root, num_audio=8, duration=1.0, seed=5, phrases_as_str=True)
    vocab = make_vocab(label_json, root / "vocab.pkl")
    phrases = sorted({p for it in json.loads(label_json.read_text())
                      for p in it["phrases"]})
    (root / "clusters.json").write_text(json.dumps(
        {i: phrases[i::3] for i in range(3)}))
    return root, label_json, len(vocab)


def _wstag_config(root, label_json, n_vocab) -> dict:
    tok = {"type": "DictTokenizer",
           "args": {"vocabulary": str(root / "vocab.pkl")}}

    def loader():
        return {
            "dataset": {"type": "AudioSamplePhrasesDataset", "args": {
                "audio": str(root / "waveform_fp.csv"),
                "label": str(label_json), "phrase_num": _N,
                "fix_neg": False, "neg_samp_stratg": "clustering",
                "cluster_map": str(root / "clusters.json"),
                "max_audio_length": 1.0, "seed": 11}},
            "collate_fn": {"type": "TextCollate", "args": {
                "text_key": "phrases", "pad_keys": ["waveform"],
                "pad_buckets": {"waveform": 32000}, "text_bucket": 4,
                "tokenizer": tok}},
            "dataloader_args": {"batch_size": 4},
        }

    return {
        "experiment_path": str(root / "exp"), "seed": 1,
        "data": {"train": loader(), "val": loader()},
        "model": {
            "type": "MultiTextBiEncoder",
            "args": {"shared_dim": _EMBED, "add_proj": True,
                     "pooling": "linear_softmax",
                     "text_forward_keys": ["text", "text_len"]},
            "audio_encoder": {"type": "Cnn8Rnn", "args": {
                "sample_rate": 32000, "gru_bwd": "v3"}},
            "text_encoder": {"type": "EmbeddingAgg",
                             "args": {"vocab_size": n_vocab,
                                      "embed_dim": _EMBED}},
            "match_fn": {"type": "DotProduct", "args": {}},
        },
        "loss": {"type": "ClipBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 2e-3}},
        "lr_scheduler": {
            "type": "torch.optim.lr_scheduler.ReduceLROnPlateau",
            "args": {"mode": "min", "patience": 3}},
        "trainer": {"epochs": 2, "early_stop": 5, "save_interval": 1,
                    "max_grad_norm": 1.0,
                    "metric_monitor": {"mode": "min", "name": "loss"}},
    }


def test_weak_phrase_runner_trains_and_its_checkpoint_loads_in_jax(
        wstag_data):
    root, label_json, n_vocab = wstag_data
    config = _wstag_config(root, label_json, n_vocab)
    exp_dir = WeakPhraseRunner(device="cpu").train(config)
    log = (exp_dir / "train.log").read_text()
    assert "epoch: 2" in log
    losses = [float(line.split("train_loss: ")[1].split()[0])
              for line in log.splitlines() if "train_loss: " in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    best = torch.load(exp_dir / "best.pth", weights_only=True)
    last = torch.load(exp_dir / "last.pth", weights_only=True)
    assert last["epoch"] == 2 and best["save_trainable_only"] is True

    # the saved weights in the JAX model give the port's outputs
    sd = last["model"]
    variables = import_biencoder({k: v.numpy() for k, v in sd.items()})
    jmodel = _jax_model("DotProduct", "linear_softmax", _EMBED, True,
                        n_vocab)
    args = config["data"]["val"]["dataset"]["args"]
    items = [JPhrases(**args)[i] for i in range(3)]
    batch = JCollate(JTok(str(root / "vocab.pkl")), text_key="phrases",
                     pad_keys=["waveform"])(items)
    jbatch = {k: (v.astype(np.float32) if v.dtype == np.float16 else v)
              for k, v in batch.items()
              if isinstance(v, np.ndarray) and v.dtype != object}
    ref = jmodel.apply(variables, jbatch, train=False)
    model = instantiate(config["model"], device="cpu")
    model.load_state_dict(sd)                            # strict
    with torch.no_grad():
        out = model(to_device(batch, torch.device("cpu")))
    for key in ("frame_sim", "clip_sim"):
        rel = _rel_rms(out[key].numpy(), np.asarray(ref[key]))
        assert rel <= 1e-4, (key, rel)


@pytest.mark.parametrize("name", ["random", "similarity", "clustering"])
def test_registry_builds_the_weak_phrase_config(name):
    with open(f"configs/weak_phrase/cnn8rnn_w2vmean_{name}.yaml") as f:
        config = yaml.safe_load(f)
    model = instantiate(config["model"], device="cpu")
    assert isinstance(model, MultiTextBiEncoder) and not model.needs_proj
    assert model.audio_encoder.rnn.route() == (torch.float32, True,
                                               torch.float32, None)
    assert isinstance(instantiate(config["loss"]), ClipBceLoss)
    for split in ("train", "val"):
        data = config["data"][split]
        assert resolve(data["dataset"]["type"]) is AudioSamplePhrasesDataset
        assert data["dataset"]["args"]["neg_samp_stratg"] == name
        assert callable(resolve(data["collate_fn"]["type"]))
    assert resolve("WeakPhraseRunner") is WeakPhraseRunner
    # the hoisted backward, as TTG_GRU_BWD picks it in the JAX package
    audio = dict(config["model"]["audio_encoder"])
    audio["args"] = {**audio["args"], "gru_bwd": "v2"}
    assert instantiate(audio).rnn.route() == (torch.float32, True,
                                              torch.float32, "v2")
