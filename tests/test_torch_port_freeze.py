"""The port's freeze masks, frozen training step and trainable-only
checkpoints against the JAX package.

* ``freeze_mask_from_model``: for every combination of
  ``freeze_audio_encoder``, ``freeze_text_encoder``, ``Cnn8Rnn.freeze_cnn``
  and ``EmbeddingAgg.freeze_embedding``, on a ``BiEncoder`` and a
  ``MultiTextBiEncoder``, the port's mask equals JAX's (mapped onto the
  port's names through ``from_jax_variables``), None when nothing is
  frozen;
* one WSTAG step with ``freeze_cnn`` and ``freeze_bn`` (dropout the
  identity): the frozen parameters and every running statistic stay bit
  for bit as they were, the loss equals JAX's (rtol 1e-5), the global
  clipping norm is taken over the trainable gradients only and equals
  optax's masked norm (rtol 1e-5; JAX's frozen gradients are set to 1e3,
  which its masked chain must ignore, and the port computes none),
  and the trainable parameters after clipping and Adam equal JAX's
  ``optax.masked`` step within 1e-5 absolute (lr 1e-3: a flipped update
  would be 2e-3 off; Adam's first update is ``lr · g / (|g| + 1e-8)``, so
  an entry whose clipped gradient is near 1e-8 moves by a fraction of lr
  that the gradients' last bits change: one entry of 393,216 in
  ``rnn.weight_ih_l0`` lies 1.7e-6 apart); ``bn_pool`` steps aside under
  ``freeze_bn`` (its
  function, made to raise, is not called; without ``freeze_bn`` it is);
* a trainable-only checkpoint: ``StrongRunner.train`` of the CDur config
  with ``freeze_text_encoder`` saves exactly the trainable parameters and
  every buffer; a resume from it starts at the saved epoch + 1; a restore
  and ``from_experiment`` merge it over the model's own fresh init (whose
  frozen weights stay the port's, not the run's); a resume into a model
  that freezes nothing raises.
"""

import itertools

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from tests.synthetic import make_grounding_data, make_vocab
from tests.test_torch_port_weak import _batch
from texttoaudiogrounding_tpu.losses import ClipBceLoss as JClipBce
from texttoaudiogrounding_tpu.models import BiEncoder as JBiEncoder
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.audio_text_model import (
    MultiTextBiEncoder as JMultiText,
)
from texttoaudiogrounding_tpu.models.match import DotProduct as JDotProduct
from texttoaudiogrounding_tpu.training import optim as joptim
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    weak_output_transform as j_output_transform,
)
from texttoaudiogrounding_tpu.training.torch_import import import_biencoder
from texttoaudiogrounding_tpu_torch import (
    GroundingPredictor,
    from_jax_variables,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.losses import ClipBceLoss
from texttoaudiogrounding_tpu_torch.models import (
    BiEncoder,
    Cnn8Rnn,
    CrnnEncoder,
    DotProduct,
    EmbeddingAgg,
    ExpNegL2,
    MultiTextBiEncoder,
)
from texttoaudiogrounding_tpu_torch.models import layers
from texttoaudiogrounding_tpu_torch.training.optim import (
    Optimizer,
    freeze_mask_from_model,
    trainable_parameters,
)
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    StrongRunner,
)
from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
    weak_output_transform,
)
from texttoaudiogrounding_tpu_torch.training.train_state import (
    load_checkpoint,
)

_VOCAB, _EMBED = 100, 32
_FLAGS = ("freeze_audio_encoder", "freeze_text_encoder", "freeze_cnn",
          "freeze_embedding")


def _jax_model(kind, flags, freeze_bn=False):
    audio = JCnn8Rnn(sample_rate=32000, freeze_cnn=flags["freeze_cnn"],
                     freeze_bn=freeze_bn)
    text = JEmbeddingAgg(vocab_size=_VOCAB, embed_dim=_EMBED,
                         freeze_embedding=flags["freeze_embedding"])
    cls = JMultiText if kind == "multi" else JBiEncoder
    extra = {"pooling": "linear_softmax"} if kind == "multi" else {}
    return cls(audio_encoder=audio, text_encoder=text,
               match_fn=JDotProduct(), shared_dim=_EMBED, add_proj=True,
               freeze_audio_encoder=flags["freeze_audio_encoder"],
               freeze_text_encoder=flags["freeze_text_encoder"], **extra)


def _port_model(kind, flags, freeze_bn=False, **audio):
    enc = Cnn8Rnn(freeze_cnn=flags["freeze_cnn"], freeze_bn=freeze_bn,
                  **audio)
    text = EmbeddingAgg(_VOCAB, _EMBED,
                        freeze_embedding=flags["freeze_embedding"])
    cls = MultiTextBiEncoder if kind == "multi" else BiEncoder
    return cls(enc, text, DotProduct(), shared_dim=_EMBED, add_proj=True,
               freeze_audio_encoder=flags["freeze_audio_encoder"],
               freeze_text_encoder=flags["freeze_text_encoder"],
               device="cpu")


@pytest.fixture(scope="module")
def port_models():
    """One port model of each kind; the mask test sets the freeze flags
    as attributes, as the constructors store them."""
    return {kind: _port_model(kind, dict.fromkeys(_FLAGS, False))
            for kind in ("bi", "multi")}


@pytest.fixture(scope="module")
def wstag_variables():
    """Variables of the JAX WSTAG model (the BiEncoder's tree is the same:
    both towers and both projections): the port's random weights from a
    numpy seed, through the JAX package's importer."""
    model = _port_model("multi", dict.fromkeys(_FLAGS, False))
    return import_biencoder({k: v.numpy() for k, v in
                             random_state_dict(model, seed=3).items()})


@pytest.mark.parametrize("kind", ["bi", "multi"])
@pytest.mark.parametrize("bits", list(itertools.product((False, True),
                                                        repeat=4)),
                         ids=lambda bits: "".join("01"[b] for b in bits))
def test_freeze_mask_matches_jax(wstag_variables, port_models, kind, bits):
    flags = dict(zip(_FLAGS, bits))
    params = wstag_variables["params"]
    jmask = joptim.freeze_mask_from_model(_jax_model(kind, flags), params)
    model = port_models[kind]
    model.freeze_audio_encoder = flags["freeze_audio_encoder"]
    model.freeze_text_encoder = flags["freeze_text_encoder"]
    model.audio_encoder.freeze_cnn = flags["freeze_cnn"]
    model.text_encoder.freeze_embedding = flags["freeze_embedding"]
    mask = freeze_mask_from_model(model)
    if not any(bits):
        assert jmask is None and mask is None
        return
    # the JAX mask as 0/1 arrays through the weight layout's mapping
    as_arrays = jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), jmask,
        params)
    ref = from_jax_variables({"params": as_arrays,
                              "batch_stats": wstag_variables["batch_stats"]},
                             model)
    assert set(mask) == {n for n in ref if n in mask}
    for name, trainable in mask.items():
        value = ref[name]
        if "bias_hh" in name:       # r/z thirds: no JAX leaf (always 0)
            value = value[2 * value.shape[0] // 3:]
        assert value.min() == value.max() == float(trainable), name


def _frozen_step_jax(variables, batch):
    """The JAX step with ``freeze_cnn`` and ``freeze_bn``: the gradient of
    the trainable parameters (the frozen trunk's are set to 1e3, which the
    masked chain must ignore), then ``build_optimizer``'s masked chain of
    clipping at 0.05 and Adam."""
    jmodel = _jax_model("multi", {**dict.fromkeys(_FLAGS, False),
                                  "freeze_cnn": True}, freeze_bn=True)
    params = variables["params"]
    mask = joptim.freeze_mask_from_model(jmodel, params)
    trunk = {k: v for k, v in params["audio_encoder"].items() if k != "rnn"}

    def loss_of(p, frozen, stats, b):
        full = {**p, "audio_encoder": {**frozen, **p["audio_encoder"]}}
        out, mut = jmodel.apply({"params": full, "batch_stats": stats}, b,
                                train=True, mutable=["batch_stats"])
        return JClipBce()(j_output_transform(out, b)), mut

    trainable = {**params, "audio_encoder": {
        "rnn": params["audio_encoder"]["rnn"]}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        # every array an argument: as constants XLA would fold the trunk
        (loss, mut), grads = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(trainable, trunk,
                                    variables["batch_stats"], batch)
    grads = {**grads, "audio_encoder": {
        **jax.tree.map(lambda a: np.full(a.shape, 1e3, np.float32), trunk),
        **grads["audio_encoder"]}}
    tx = joptim.build_optimizer({"type": "Adam", "args": {"lr": 1e-3}},
                                params=params, model=jmodel,
                                max_grad_norm=0.05)
    # jitted: leaf by leaf, eager optax compiles each operation anew
    new = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params)
    trainable_norm = float(optax.global_norm(jax.tree.map(
        lambda g, m: g if m else np.zeros_like(g), grads, mask)))
    return float(loss), mut, new, trainable_norm


def test_frozen_step_matches_the_jax_masked_step(wstag_variables):
    batch = _batch()
    jloss, jmut, jnew, jnorm = _frozen_step_jax(wstag_variables, batch)
    flags = {**dict.fromkeys(_FLAGS, False), "freeze_cnn": True}
    model = _port_model("multi", flags, freeze_bn=True, dropout=(0.0, 0.0),
                        bn_pool=(64, 128, 256, 512))
    model.load_state_dict(from_jax_variables(wstag_variables, model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mask = freeze_mask_from_model(model)
    opt = Optimizer({"type": "Adam", "args": {"lr": 1e-3}},
                    trainable_parameters(model, mask), max_grad_norm=0.05)
    assert {id(p) for p in opt.params} == {
        id(p) for n, p in model.named_parameters() if mask[n]}
    tb = to_device(batch, torch.device("cpu"))

    def refuse(*args, **kwargs):
        raise AssertionError("bn_pool ran with running statistics")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "bn_relu_dual_pool", refuse)
        model.train()
        loss = ClipBceLoss()(weak_output_transform(model(tb), tb))
        opt.zero_grad()
        loss.backward()
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in opt.params))
        opt.step()
        after = {k: v.clone() for k, v in model.state_dict().items()}
        # without freeze_bn the train-mode BN takes the kernel's route
        model.audio_encoder.freeze_bn = False
        with pytest.raises(AssertionError, match="bn_pool"):
            model(tb)
    assert loss.item() == pytest.approx(jloss, rel=1e-5)
    assert float(norm) == pytest.approx(jnorm, rel=1e-5)
    new = from_jax_variables({"params": jnew,
                              "batch_stats": jmut["batch_stats"]}, model)
    frozen = [n for n, keep in mask.items() if not keep]
    assert len(frozen) == 28 and all(
        n.startswith("audio_encoder.") and ".rnn." not in n for n in frozen)
    for name, value in after.items():
        if name in frozen or "running" in name or "num_batches" in name:
            assert torch.equal(value, before[name]), name
            if "running" in name:       # JAX's statistics stay too
                assert torch.equal(new[name], before[name]), name
        else:
            assert not torch.equal(value, before[name]), name
            np.testing.assert_allclose(value.numpy(), new[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def _cdur_config(tmp_path):
    wav_csv, label_json, _ = make_grounding_data(
        tmp_path / "data", num_audio=4, duration=1.0, seed=6,
        event_len=(0.15, 0.3))
    vocab_path = tmp_path / "data" / "vocab.pkl"
    make_vocab(label_json, vocab_path)
    with open("configs/strong/cdur_w2vmean.yaml") as f:
        config = yaml.safe_load(f)
    for split in ("train", "val"):
        cfg = config["data"][split]
        cfg["dataset"]["args"].update(waveform=str(wav_csv),
                                      label=str(label_json))
        cfg["collate_fn"]["args"]["tokenizer"]["args"]["vocabulary"] = str(
            vocab_path)
        cfg["dataloader_args"] = {"batch_size": 2, "num_workers": 0}
    config["model"]["args"]["freeze_text_encoder"] = True
    config["model"]["audio_encoder"]["args"]["embed_dim"] = _EMBED
    config["model"]["text_encoder"]["args"]["embed_dim"] = _EMBED
    config["trainer"].update(epochs=1, save_trainable_only=True,
                             include_optim_in_ckpt=True)
    return config


def test_trainable_only_checkpoint_round_trip(tmp_path):
    config = _cdur_config(tmp_path)
    config["experiment_path"] = str(tmp_path / "run")
    exp_dir = StrongRunner(device="cpu").train(config)
    saved = load_checkpoint(exp_dir / "last.pth")
    runner = StrongRunner(device="cpu")
    runner.setup(config)
    fresh = runner.build_model()
    trainable = {n for n, _ in fresh.named_parameters()
                 if not n.startswith("text_encoder.")}
    buffers = {n for n, _ in fresh.named_buffers()}
    assert saved["trainables_only"] and saved["epoch"] == 1
    assert set(saved["model"]) == trainable | buffers
    assert saved["optimizer"]["state"] and len(
        saved["optimizer"]["param_groups"][0]["params"]) == len(trainable)

    # resume: the next epoch, Adam's state over the same trainables
    resumed = dict(config, experiment_path=str(tmp_path / "resumed"),
                   resume=str(exp_dir / "last.pth"),
                   trainer={**config["trainer"], "epochs": 2})
    log = (StrongRunner(device="cpu").train(resumed) / "train.log"
           ).read_text()
    assert "epoch: 2" in log and "epoch: 1 " not in log

    # restore over the model's own init: the trainables are the run's,
    # the frozen table stays the fresh model's
    table = fresh.text_encoder.embedding.core.weight.detach().clone()
    StrongRunner(device="cpu").restore_state(fresh, exp_dir, "last")
    state = fresh.state_dict()
    for name, value in saved["model"].items():
        assert torch.equal(state[name], value), name
    assert torch.equal(fresh.text_encoder.embedding.core.weight, table)
    pred = GroundingPredictor.from_experiment(exp_dir, which="last",
                                              device="cpu")
    served = pred.model.state_dict()
    assert all(torch.equal(served[n], v) for n, v in saved["model"].items())

    # a model that freezes nothing cannot take it for a full resume
    plain = dict(resumed, experiment_path=str(tmp_path / "plain"))
    plain["model"] = {**config["model"], "args": {
        k: v for k, v in config["model"]["args"].items()
        if k != "freeze_text_encoder"}}
    with pytest.raises(ValueError, match="trainable-only"):
        StrongRunner(device="cpu").train(plain)


def test_pretrained_embedding_is_loaded_and_checked(tmp_path):
    table = np.random.default_rng(2).normal(size=(7, 4)).astype(np.float32)
    np.save(tmp_path / "w2v.npy", table)
    agg = EmbeddingAgg(7, 4, pretrained_embedding=str(tmp_path / "w2v.npy"),
                       freeze_embedding=True)
    np.testing.assert_array_equal(agg.embedding.core.weight.detach().numpy(),
                                  table)
    with pytest.raises(ValueError, match="shape"):
        EmbeddingAgg(8, 4, pretrained_embedding=str(tmp_path / "w2v.npy"))
    model = BiEncoder(CrnnEncoder(embed_dim=4), agg, ExpNegL2(),
                      shared_dim=4, device="cpu")
    mask = freeze_mask_from_model(model)
    assert [n for n, keep in mask.items() if not keep] == [
        "text_encoder.embedding.core.weight"]
