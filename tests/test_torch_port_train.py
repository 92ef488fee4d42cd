"""The port's strong-supervision trainer against the JAX package.

Same weights (the JAX init, carried over by ``from_jax_variables``) and
the same numpy inputs go through both packages, dropout made the identity
on both sides (flax's ``nn.Dropout.__call__`` monkeypatched, the port's
probabilities set to 0).  Tolerances:

* train-mode ``ConvBlock`` (narrow, one block): forward, input and
  parameter gradients rtol 1e-4 / atol 1e-5; running statistics 1e-6;
* clipping + Adam on identical gradients against
  ``optax.chain(clip_by_global_norm, adam)``: 2e-7 absolute on the
  parameters (a few f32 ulps at |p| <= 1);
* one whole train step of ``BiEncoder(Cnn8Rnn, EmbeddingAgg, ExpNegL2)``
  at the flagship audio width on 1 s clips: loss rtol 1e-5; gradients by
  relative RMS per parameter, 1e-4 for everything after the conv trunk
  (fc1, BiGRU, projections, text) and 2e-2 for the conv trunk (convs,
  BatchNorms), where f32 itself is that far off: on this batch the JAX f32
  step's trunk gradients lie up to 1.05e-2 from an f64 evaluation and the
  port's up to 4.1e-3; mutated running statistics 1e-5 absolute;
* ``StrongRunner.train`` end to end: the saved model goes through
  ``import_biencoder`` into the JAX model and gives ``frame_sim`` within
  1e-4.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.synthetic import make_grounding_data, make_vocab
from texttoaudiogrounding_tpu.data.collate import TextCollate as JCollate
from texttoaudiogrounding_tpu.data.datasets import (
    AudioPhraseDataset as JDataset,
)
from texttoaudiogrounding_tpu.data.tokenizer import DictTokenizer as JTok
from texttoaudiogrounding_tpu.losses import FrameBceLoss as JFrameBce
from texttoaudiogrounding_tpu.models import BiEncoder as JBiEncoder
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.layers import ConvBlock as JConvBlock
from texttoaudiogrounding_tpu.models.match import ExpNegL2 as JExpNegL2
from texttoaudiogrounding_tpu.training import optim as joptim
from texttoaudiogrounding_tpu.training.runner_strong import (
    strong_output_transform as j_output_transform,
)
from texttoaudiogrounding_tpu.training.torch_import import import_biencoder
from texttoaudiogrounding_tpu_torch import from_jax_variables
from texttoaudiogrounding_tpu_torch.data.collate import TextCollate
from texttoaudiogrounding_tpu_torch.data.datasets import AudioPhraseDataset
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
from texttoaudiogrounding_tpu_torch.losses import FrameBceLoss
from texttoaudiogrounding_tpu_torch.models import (
    BiEncoder,
    Cnn8Rnn,
    EmbeddingAgg,
    ExpNegL2,
)
from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock
from texttoaudiogrounding_tpu_torch.training import optim
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    StrongRunner,
    strong_output_transform,
)
from texttoaudiogrounding_tpu_torch.utils.registry import resolve

_VOCAB, _EMBED = 100, 32


def _rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)
                         / max(np.mean(ref ** 2), 1e-30)))


def test_train_mode_conv_block_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 8, 4)).astype(np.float32)
    g = rng.normal(size=(2, 6, 4, 8)).astype(np.float32)
    jblock = JConvBlock(8)
    var = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x), bn_train=False)
    p, stats = var["params"], var["batch_stats"]
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        stats)

    def jloss(params, xx):
        out, mut = jblock.apply({"params": params, "batch_stats": stats},
                                xx, bn_train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut["batch_stats"])

    (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    block = ConvBlock(4, 8)
    with torch.no_grad():
        for conv in ("conv1", "conv2"):
            getattr(block, conv).weight.copy_(torch.from_numpy(
                np.array(p[conv]["kernel"]).transpose(3, 2, 0, 1)))
        for bn in ("bn1", "bn2"):
            mod = getattr(block, bn)
            mod.weight.copy_(torch.from_numpy(np.array(p[bn]["scale"])))
            mod.bias.copy_(torch.from_numpy(np.array(p[bn]["bias"])))
            mod.running_mean.copy_(torch.from_numpy(
                np.array(stats[bn]["mean"])))
            mod.running_var.copy_(torch.from_numpy(
                np.array(stats[bn]["var"])))
    block.train()
    tx = torch.from_numpy(x).requires_grad_()
    out = block(tx, (2, 2))
    (out * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **tol)
    for conv in ("conv1", "conv2"):
        np.testing.assert_allclose(
            getattr(block, conv).weight.grad.numpy(),
            np.asarray(jgp[conv]["kernel"]).transpose(3, 2, 0, 1), **tol)
    for bn in ("bn1", "bn2"):
        mod = getattr(block, bn)
        np.testing.assert_allclose(mod.weight.grad.numpy(),
                                   np.asarray(jgp[bn]["scale"]), **tol)
        np.testing.assert_allclose(mod.bias.grad.numpy(),
                                   np.asarray(jgp[bn]["bias"]), **tol)
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(jstats[bn]["mean"]), atol=1e-6)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(jstats[bn]["var"]), atol=1e-6)


def test_clip_and_adam_match_optax():
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    init = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    # norms: above 1 (clipped), below 1 (left alone), above again
    grads = [[rng.normal(0, scale, s).astype(np.float32) for s in shapes]
             for scale in (0.8, 0.05, 3.0)]
    tx = joptim.build_optimizer({"type": "Adam", "args": {"lr": 1e-3}},
                                max_grad_norm=1.0)
    jparams = [jnp.asarray(a) for a in init]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = optim.Optimizer({"type": "Adam", "args": {"lr": 1e-3}}, params,
                          max_grad_norm=1.0)
    for step, gs in enumerate(grads):
        if step == 2:        # the plateau scheduler's move between steps
            state = joptim.set_learning_rate(state, 1e-4)
            opt.lr = 1e-4
        assert opt.lr == pytest.approx(joptim.get_learning_rate(state))
        updates, state = tx.update([jnp.asarray(g) for g in gs], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       rtol=0, atol=2e-7)


def test_plateau_and_early_stop_decisions_match_jax():
    losses = [1.0, 0.9, 0.95, 0.91, 0.9, 0.92, 0.5, 0.6, 0.7, 0.8, 0.9]
    jsched = joptim.ReduceLROnPlateau(mode="min", factor=0.1, patience=2)
    sched = optim.ReduceLROnPlateau(mode="min", factor=0.1, patience=2)
    jmon, mon = joptim.MetricImprover("min"), optim.MetricImprover("min")
    jlr = lr = 1e-3
    for value in losses:
        jlr, lr = jsched.step(value, jlr), sched.step(value, lr)
        assert lr == jlr and mon(value) == jmon(value)
    assert lr < 1e-3


def _jax_model(vocab_size):
    return JBiEncoder(
        audio_encoder=JCnn8Rnn(sample_rate=32000),
        text_encoder=JEmbeddingAgg(vocab_size=vocab_size, embed_dim=_EMBED),
        match_fn=JExpNegL2(), shared_dim=_EMBED, add_proj=True)


def _port_model(vocab_size, dropout=(0.2, 0.5)):
    return BiEncoder(Cnn8Rnn(dropout=dropout),
                     EmbeddingAgg(vocab_size, _EMBED), ExpNegL2(),
                     shared_dim=_EMBED, add_proj=True, device="cpu")


def _step_model(variables):
    model = _port_model(_VOCAB, dropout=(0.0, 0.0))
    model.load_state_dict(from_jax_variables(variables))
    return model


def _step_batch():
    rng = np.random.default_rng(11)
    return {
        "waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(np.float32),
        "waveform_len": np.array([32000, 21000], np.int32),
        "text": np.array([[2, 3, 4, 0], [5, 6, 0, 0]], np.int32),
        "text_len": np.array([3, 2], np.int32),
        "label": (rng.random((2, 26)) > 0.6).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_step():
    """The JAX runner's train step (value and gradient of the frame BCE
    through ``strong_output_transform``, batch statistics mutated) with
    dropout made the identity."""
    batch = _step_batch()
    jmodel = _jax_model(_VOCAB)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        def loss_of(params):
            out, mut = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch, train=True, mutable=["batch_stats"])
            return JFrameBce()(j_output_transform(out, batch)), mut

        (loss, mut), grads = jax.value_and_grad(loss_of, has_aux=True)(
            variables["params"])
    finally:
        mp.undo()
    ref = from_jax_variables(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": mut["batch_stats"]}))
    return variables, batch, float(loss), ref


def test_whole_train_step_matches_the_jax_runner(jax_step):
    variables, batch, jloss, ref = jax_step
    model = _step_model(variables)
    model.train()
    tb = to_device(batch, torch.device("cpu"))
    loss = FrameBceLoss()(strong_output_transform(model(tb), tb))
    loss.backward()
    assert loss.item() == pytest.approx(jloss, rel=1e-5)
    for name, p in model.named_parameters():
        trunk = "conv_block" in name or "bn0" in name
        rel = _rel_rms(p.grad.numpy(), ref[name].numpy())
        assert rel <= (2e-2 if trunk else 1e-4), (name, rel)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_bias_hh_rz_stay_zero_through_steps(jax_step):
    variables, batch, _, _ = jax_step
    model = _step_model(variables)
    rnn = model.audio_encoder.rnn
    h = rnn.hidden
    before = {n: getattr(rnn, n).detach().clone()
              for n in ("bias_hh_l0", "bias_hh_l0_reverse")}
    assert not any(b[:2 * h].any() for b in before.values())
    runner = StrongRunner(device="cpu")
    opt = optim.Optimizer({"type": "Adam", "args": {"lr": 1e-3}},
                          model.parameters(), max_grad_norm=1.0)
    tb = to_device(batch, torch.device("cpu"))
    for _ in range(2):
        runner.train_step(model, FrameBceLoss(), opt, tb,
                          strong_output_transform)
    for name, b in before.items():
        after = getattr(rnn, name).detach()
        assert not after[:2 * h].any(), name          # r/z: still zero
        assert not torch.equal(after[2 * h:], b[2 * h:]), name  # n moves


@pytest.fixture(scope="module")
def grounding_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_strong")
    wav_csv, label_json, _ = make_grounding_data(
        root / "data", num_audio=8, duration=1.0, seed=3,
        event_len=(0.15, 0.3))
    vocab_path = root / "data" / "vocab.pkl"
    vocab = make_vocab(label_json, vocab_path)
    return root, wav_csv, label_json, vocab_path, len(vocab)


def _collate_args():
    return {"text_key": "phrase", "pad_keys": ["waveform", "label"],
            "pad_buckets": {"waveform": 32000, "label": 26},
            "text_bucket": 4}


def test_dataset_and_collate_match_jax(grounding_data):
    _, wav_csv, label_json, vocab_path, _ = grounding_data
    ds = AudioPhraseDataset(str(wav_csv), str(label_json), 0.04)
    jds = JDataset(str(wav_csv), str(label_json), 0.04)
    assert len(ds) == len(jds)
    items = [ds[i] for i in range(len(ds))]
    jitems = [jds[i] for i in range(len(jds))]
    for it, jit in zip(items, jitems):
        np.testing.assert_array_equal(it["label"], jit["label"])
        np.testing.assert_array_equal(it["waveform"], jit["waveform"])
        assert it["waveform"].dtype == np.float16
    args = _collate_args()
    batch = TextCollate(DictTokenizer(str(vocab_path)), **args)(items[:4])
    jbatch = JCollate(JTok(str(vocab_path)), **args)(jitems[:4])
    assert set(batch) == set(jbatch)
    for key, value in jbatch.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(batch[key], value, err_msg=key)
        else:
            assert batch[key] == value, key


def test_strong_config_names_resolve():
    import yaml
    with open("configs/strong/biencoder_train.yaml") as f:
        config = yaml.safe_load(f)
    names = []

    def walk(node):
        if isinstance(node, dict):
            if "type" in node and node["type"] != "Adam":
                names.append(node["type"])
            for value in node.values():
                walk(value)

    walk(config)
    assert len(names) >= 9
    for name in names:
        assert callable(resolve(name)), name


def test_strong_runner_trains_and_its_checkpoint_loads_in_jax(tmp_path):
    # four clips: one step an epoch, so that five epochs stay short
    root = tmp_path
    wav_csv, label_json, _ = make_grounding_data(
        root / "data", num_audio=4, duration=1.0, seed=3,
        event_len=(0.15, 0.3))
    vocab_path = root / "data" / "vocab.pkl"
    n_vocab = len(make_vocab(label_json, vocab_path))

    def loader(batch_size):
        return {
            "dataset": {"type": "AudioPhraseDataset",
                        "args": {"waveform": str(wav_csv),
                                 "label": str(label_json),
                                 "time_resolution": 0.04}},
            "collate_fn": {"type": "TextCollate", "args": {
                **_collate_args(),
                "tokenizer": {"type": "DictTokenizer",
                              "args": {"vocabulary": str(vocab_path)}}}},
            "dataloader_args": {"batch_size": batch_size},
        }

    config = {
        "experiment_path": str(root / "exp"),
        "seed": 1,
        "data": {"train": loader(4), "val": loader(4)},
        "model": {
            "type": "BiEncoder",
            "args": {"shared_dim": _EMBED, "add_proj": True},
            "audio_encoder": {"type": "Cnn8Rnn",
                              "args": {"sample_rate": 32000}},
            "text_encoder": {"type": "EmbeddingAgg",
                             "args": {"vocab_size": n_vocab,
                                      "embed_dim": _EMBED}},
            "match_fn": {"type": "ExpNegL2", "args": {}},
        },
        "loss": {"type": "FrameBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 2e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "factor": 0.1,
                                  "patience": 3}},
        "trainer": {"epochs": 5, "early_stop": 10, "save_interval": 1,
                    "max_grad_norm": 1.0,
                    "metric_monitor": {"mode": "min", "name": "loss"}},
    }
    runner = StrongRunner(device="cpu")
    exp_dir = runner.train(config)
    log = (exp_dir / "train.log").read_text()
    assert "epoch: 5" in log and "TF32 off" in log
    losses = [float(line.split("train_loss: ")[1].split()[0])
              for line in log.splitlines() if "train_loss: " in line]
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert json.loads((exp_dir / "config.json").read_text())["seed"] == 1
    best = torch.load(exp_dir / "best.pth", weights_only=True)
    last = torch.load(exp_dir / "last.pth", weights_only=True)
    assert last["epoch"] == 5 and "optimizer" in last
    assert {"lr_scheduler", "metric_monitor", "not_improve_cnt"} <= set(best)

    # the saved weights in the JAX model give the port's frame_sim
    sd = best["model"]
    variables = import_biencoder({k: v.numpy() for k, v in sd.items()})
    jmodel = _jax_model(n_vocab)
    ds = AudioPhraseDataset(str(wav_csv), str(label_json), 0.04)
    collate = TextCollate(DictTokenizer(str(vocab_path)),
                          **_collate_args())
    batch = collate([ds[i] for i in range(3)])
    jbatch = {k: (v.astype(np.float32) if v.dtype == np.float16 else v)
              for k, v in batch.items()
              if isinstance(v, np.ndarray) and v.dtype != object}
    # one jitted call: the eager forward compiles every op on its own
    ref = np.asarray(jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False)["frame_sim"])(variables, jbatch))
    model = _port_model(n_vocab)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(to_device(batch, torch.device("cpu")))["frame_sim"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
