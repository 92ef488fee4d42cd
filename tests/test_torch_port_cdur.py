"""The port's CDur strong configuration against the JAX package.

``configs/strong/cdur_w2vmean.yaml`` trains ``BiEncoder(CrnnEncoder,
EmbeddingAgg, ExpNegL2)`` at 0.08 s frames.  The same numpy inputs and,
through ``from_jax_variables``, the same weights go through both packages
on 1 s clips (dropout the identity on both sides where a step is held):
the port's random weights from a numpy seed, carried to the JAX model by
``jax_cdur_variables``, which ``from_jax_variables`` inverts exactly.
Tolerances:

* the CDur log-mel (n_fft 2048, 40 ms window, 20 ms hop, 64 HTK mels):
  1e-4 dB absolute (measured ~1e-5);
* ``CDurBlock`` (BN over the input channels, 3x3 conv, LeakyReLU 0.1) in
  train and eval mode: forward, input and parameter gradients rtol 1e-4 /
  atol 1e-5, running statistics 1e-6;
* ``lp_pool_2d`` (p = 4, windows (2, 4) and (1, 4), spatial axes
  floor-divided): forward and gradient rtol 1e-4 / atol 1e-6;
* ``CrnnEncoder`` in train and eval mode: the embedding within 1e-4
  relative RMS (measured ~2e-6), the lengths equal, the train-mode
  running statistics 1e-5 absolute and relative (block 1's BN is over the
  log-mel in dB: its batch variance, ``E[x²] - E[x]²`` at a mean of tens
  of dB, reads 8e-6 relative apart between the two packages' sums);
* one whole strong train step (``FrameBceLoss`` through
  ``strong_output_transform``; the JAX step under ``jax.jit``, one compile
  for it and its scaled twin): loss rtol 1e-5, gradients by relative RMS
  per parameter, 1e-4 after the conv trunk (BiGRU, text; measured <= 1e-5)
  and in it 2e-2 (the port's existing f32 step bounds; measured <= 2.5e-5)
  or twice the sum of the two packages' own changes when the waveform is
  scaled by 1 + 1e-6, whichever is larger.  One entry needs the second
  bound: block 1's BN scale, a single number summed over the whole log-mel
  with heavy cancellation, lies 0.18 apart between the packages, 0.175
  from the port's own f64 step in f32, and moves by 0.17 (port) and 0.21
  (JAX) under the scaling.  Running statistics as the encoder's;
* the ``train_cdur`` phase of ``chip_smoke.py`` trains the YAML's keys
  except the cuts it lists; the YAML itself builds and trains through
  ``StrongRunner.train`` on the CPU.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from tests.synthetic import make_grounding_data, make_vocab
from tests.test_torch_port_train import _rel_rms
from texttoaudiogrounding_tpu.losses import FrameBceLoss as JFrameBce
from texttoaudiogrounding_tpu.models import BiEncoder as JBiEncoder
from texttoaudiogrounding_tpu.models import CrnnEncoder as JCrnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.layers import CDurBlock as JCDurBlock
from texttoaudiogrounding_tpu.models.layers import lp_pool_2d as j_lp_pool
from texttoaudiogrounding_tpu.models.match import ExpNegL2 as JExpNegL2
from texttoaudiogrounding_tpu.ops import frontend as jfrontend
from texttoaudiogrounding_tpu.training.runner_strong import (
    strong_output_transform as j_output_transform,
)
from texttoaudiogrounding_tpu.training.torch_import import (
    import_bigru,
    import_embedding_agg,
)
from texttoaudiogrounding_tpu_torch import (
    from_jax_variables,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.losses import FrameBceLoss
from texttoaudiogrounding_tpu_torch.models import (
    BiEncoder,
    CrnnEncoder,
    EmbeddingAgg,
    ExpNegL2,
)
from texttoaudiogrounding_tpu_torch.models.layers import CDurBlock, lp_pool_2d
from texttoaudiogrounding_tpu_torch.ops import frontend
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    StrongRunner,
    strong_output_transform,
)
from texttoaudiogrounding_tpu_torch.training.train_state import (
    load_checkpoint,
)

_VOCAB, _EMBED = 60, 32
_YAML = "configs/strong/cdur_w2vmean.yaml"


def _wave(seed=0):
    rng = np.random.default_rng(seed)
    return {"waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(
                np.float32),
            "waveform_len": np.array([32000, 21000], np.int32)}


def test_cdur_log_mel_matches_jax():
    wav = _wave()["waveform"]
    cfg = frontend.cdur_mel_config(32000)
    assert (cfg.n_fft, cfg.win_length, cfg.hop_length, cfg.mel_scale,
            cfg.norm) == (2048, 1280, 640, "htk", None)
    ref = np.asarray(jfrontend.log_mel_spectrogram(
        jnp.asarray(wav), jfrontend.cdur_mel_config(32000)))
    got = frontend.log_mel_spectrogram(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == ref.shape == (2, 51, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _port_block(p, stats, cin, cout):
    block = CDurBlock(cin, cout)
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(
            np.array(p["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)))
        block.bn.weight.copy_(torch.from_numpy(
            np.array(p["BatchNorm_0"]["scale"])))
        block.bn.bias.copy_(torch.from_numpy(
            np.array(p["BatchNorm_0"]["bias"])))
        block.bn.running_mean.copy_(torch.from_numpy(
            np.array(stats["BatchNorm_0"]["mean"])))
        block.bn.running_var.copy_(torch.from_numpy(
            np.array(stats["BatchNorm_0"]["var"])))
    return block


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cdur_block_matches_jax(train):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 8, 3)).astype(np.float32)
    g = rng.normal(size=(2, 10, 8, 5)).astype(np.float32)
    jblock = JCDurBlock(5)
    var = jblock.init(jax.random.PRNGKey(2), jnp.asarray(x), bn_train=False)
    p = var["params"]
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        var["batch_stats"])

    def jloss(params, xx):
        out, mut = jblock.apply({"params": params, "batch_stats": stats}, xx,
                                bn_train=train, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut["batch_stats"])

    (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    block = _port_block(p, stats, 3, 5)
    block.train(train)
    tx = torch.from_numpy(x).requires_grad_()
    out = block(tx)
    (out * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(
        block.conv.weight.grad.numpy(),
        np.asarray(jgp["Conv_0"]["kernel"]).transpose(3, 2, 0, 1), **tol)
    np.testing.assert_allclose(block.bn.weight.grad.numpy(),
                               np.asarray(jgp["BatchNorm_0"]["scale"]), **tol)
    np.testing.assert_allclose(block.bn.bias.grad.numpy(),
                               np.asarray(jgp["BatchNorm_0"]["bias"]), **tol)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(block.bn, name).numpy(),
            np.asarray(jstats["BatchNorm_0"][key]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", [(2, 4), (1, 4)])
def test_lp_pool_matches_jax(window):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)   # ragged T, M
    out_shape = (2, 9 // window[0], 11 // window[1], 3)
    g = rng.normal(size=out_shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda a: j_lp_pool(a, 4, window), jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    out = lp_pool_2d(tx, 4, window)
    (out * torch.from_numpy(g)).sum().backward()
    assert out.shape == out_shape
    tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **tol)


def _jax_bi_encoder():
    return JBiEncoder(
        audio_encoder=JCrnn(sample_rate=32000, embed_dim=_EMBED),
        text_encoder=JEmbeddingAgg(vocab_size=_VOCAB, embed_dim=_EMBED),
        match_fn=JExpNegL2(), shared_dim=_EMBED)


def jax_cdur_variables(sd: dict) -> dict:
    """A port ``BiEncoder`` / ``MultiTextBiEncoder`` state dict with a
    ``CrnnEncoder`` tower (numpy values) → the JAX model's variables: the
    inverse of ``from_jax_variables``, flax's auto-names, the BiGRU and the
    text tower through the JAX package's importers."""
    params, stats = {}, {}
    for i in range(5):
        blk = f"audio_encoder.block{i + 1}"
        params[f"CDurBlock_{i}"] = {
            "BatchNorm_0": {"scale": sd[f"{blk}.bn.weight"],
                            "bias": sd[f"{blk}.bn.bias"]},
            "Conv_0": {"kernel": sd[f"{blk}.conv.weight"].transpose(
                2, 3, 1, 0)}}
        stats[f"CDurBlock_{i}"] = {"BatchNorm_0": {
            "mean": sd[f"{blk}.bn.running_mean"],
            "var": sd[f"{blk}.bn.running_var"]}}
    params["gru"] = import_bigru(sd, "audio_encoder.gru")
    return {"params": {"audio_encoder": params,
                       "text_encoder": import_embedding_agg(
                           sd, prefix="text_encoder.")},
            "batch_stats": {"audio_encoder": stats}}


def _port_bi_encoder():
    return BiEncoder(CrnnEncoder(embed_dim=_EMBED),
                     EmbeddingAgg(_VOCAB, _EMBED), ExpNegL2(),
                     shared_dim=_EMBED, device="cpu")


@pytest.fixture(scope="module")
def cdur_variables():
    """The CDur ``BiEncoder``'s weights, random from a numpy seed, as JAX
    variables; ``from_jax_variables`` takes them back exactly."""
    sd = {k: v.numpy() for k, v in random_state_dict(
        _port_bi_encoder(), seed=4).items()}
    variables = jax_cdur_variables(sd)
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for name, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[name], err_msg=name)
    return variables


@pytest.fixture(scope="module")
def crnn_variables(cdur_variables):
    return (JCrnn(sample_rate=32000, embed_dim=_EMBED),
            {k: v["audio_encoder"] for k, v in cdur_variables.items()})


def _encoder_sd(variables):
    """The CrnnEncoder entries of ``from_jax_variables`` on a model tree
    with this tower, without their ``audio_encoder.`` prefix."""
    full = {"params": {"audio_encoder": variables["params"],
                       "text_encoder": {"embedding": {"embed": {
                           "embedding": np.zeros((2, 2), np.float32)}}}},
            "batch_stats": {"audio_encoder": variables["batch_stats"]}}
    return {k[len("audio_encoder."):]: v
            for k, v in from_jax_variables(full).items()
            if k.startswith("audio_encoder.")}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_crnn_encoder_matches_jax(crnn_variables, train):
    jm, variables = crnn_variables
    batch = _wave(4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        ref, mut = jax.jit(lambda v, b: jm.apply(
            v, b, train=train, mutable=["batch_stats"]))(variables, batch)
    enc = CrnnEncoder(embed_dim=_EMBED)
    enc.load_state_dict(_encoder_sd(variables))                # strict
    assert enc.time_resolution == pytest.approx(0.08)
    enc.train(train)
    enc.dropout = 0.0
    with torch.no_grad():
        out = enc(to_device(batch, torch.device("cpu")))
    assert out["embedding"].shape == ref["embedding"].shape == (2, 12, 32)
    np.testing.assert_array_equal(out["length"].numpy(),
                                  np.asarray(ref["length"]))
    assert _rel_rms(out["embedding"].numpy(), ref["embedding"]) <= 1e-4
    if train:
        want = _encoder_sd({"params": variables["params"],
                            "batch_stats": mut["batch_stats"]})
        for name, buf in enc.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=name)


def test_crnn_encoder_draws_dropout_in_train_mode():
    enc = CrnnEncoder(embed_dim=_EMBED)
    batch = to_device(_wave(5), torch.device("cpu"))
    enc.train()
    torch.manual_seed(0)
    with torch.no_grad():
        a = enc(batch)["embedding"]
        b = enc(batch)["embedding"]
    assert not torch.equal(a, b)                  # a new mask each call
    enc.eval()
    with torch.no_grad():
        assert torch.equal(enc(batch)["embedding"], enc(batch)["embedding"])


def _step_batch():
    rng = np.random.default_rng(11)
    return {**_wave(6),
            "text": np.array([[2, 3, 4, 0], [5, 6, 0, 0]], np.int32),
            "text_len": np.array([3, 2], np.int32),
            "label": (rng.random((2, 13)) > 0.6).astype(np.float32)}


def _scaled(batch: dict, factor: float) -> dict:
    return dict(batch, waveform=(batch["waveform"] * np.float32(factor))
                .astype(np.float32))


def _port_step(variables, batch):
    model = _port_bi_encoder()
    model.audio_encoder.dropout = 0.0
    assert not model.needs_proj
    model.load_state_dict(from_jax_variables(variables))        # strict
    model.train()
    tb = to_device(batch, torch.device("cpu"))
    loss = FrameBceLoss()(strong_output_transform(model(tb), tb))
    loss.backward()
    return model, loss.item()


def test_cdur_strong_step_matches_the_jax_runner(cdur_variables):
    batch = _step_batch()
    jmodel = _jax_bi_encoder()
    variables = cdur_variables

    def loss_of(params, stats, b):
        out, mut = jmodel.apply({"params": params, "batch_stats": stats}, b,
                                train=True, mutable=["batch_stats"])
        return JFrameBce()(j_output_transform(out, b)), mut

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        # one compile serves the step and its scaled twin
        step = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
        (jloss, mut), grads = step(variables["params"],
                                   variables["batch_stats"], batch)
        _, grads_s = step(variables["params"], variables["batch_stats"],
                          _scaled(batch, 1 + 1e-6))
    ref, ref_s = (from_jax_variables(jax.tree.map(
        np.asarray, {"params": g, "batch_stats": mut["batch_stats"]}))
        for g in (grads, grads_s))
    model, loss = _port_step(variables, batch)
    model_s, _ = _port_step(variables, _scaled(batch, 1 + 1e-6))
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    grads_port_s = dict(model_s.named_parameters())
    params = list(model.named_parameters())
    assert sum(".block" in n for n, _ in params) == 15
    for name, p in params:
        rel = _rel_rms(p.grad.numpy(), ref[name].numpy())
        if ".block" in name:
            own = (_rel_rms(grads_port_s[name].grad.numpy(), p.grad.numpy())
                   + _rel_rms(ref_s[name].numpy(), ref[name].numpy()))
            assert rel <= max(2e-2, 2 * own), (name, rel, own)
        else:
            assert rel <= 1e-4, (name, rel)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def _paths(node, prefix=""):
    """Every leaf of a nested dict as ``dotted.path -> value``; a path
    that ``chip_smoke.CDUR_CUTS`` lists is a leaf."""
    if not isinstance(node, dict) or prefix[:-1] in chip_smoke.CDUR_CUTS:
        return {prefix[:-1]: node}
    out = {}
    for key, value in node.items():
        out.update(_paths(value, f"{prefix}{key}."))
    return out


def test_chip_smoke_cdur_config_is_the_yaml():
    with open(_YAML) as f:
        want = _paths(yaml.safe_load(f))
    data = ({"a0": np.zeros(4, np.float16)}, [{"audio_id": "a0"}])
    got = _paths(chip_smoke._cdur_config("exp", data, data, "vocab.pkl"))
    differ = {k for k in set(want) | set(got)
              if k not in want or k not in got or not (
                  got[k] is want[k] or got[k] == want[k])}
    assert differ == set(chip_smoke.CDUR_CUTS)
    assert got["trainer.epochs"] == chip_smoke.CDUR_EPOCHS
    assert got["trainer.profile"] == {"start_step": 2, "num_steps": 2}


def test_cdur_yaml_trains_through_the_strong_runner(tmp_path):
    wav_csv, label_json, _ = make_grounding_data(
        tmp_path / "data", num_audio=4, duration=1.0, seed=5,
        event_len=(0.15, 0.3))
    vocab_path = tmp_path / "data" / "vocab.pkl"
    make_vocab(label_json, vocab_path)
    with open(_YAML) as f:
        config = yaml.safe_load(f)
    config["experiment_path"] = str(tmp_path / "exp")
    for split in ("train", "val"):
        cfg = config["data"][split]
        cfg["dataset"]["args"].update(waveform=str(wav_csv),
                                      label=str(label_json))
        cfg["collate_fn"]["args"]["tokenizer"]["args"]["vocabulary"] = str(
            vocab_path)
        cfg["dataloader_args"] = {"batch_size": 2, "num_workers": 0}
    config["trainer"].update(epochs=1, profile={"start_step": 1,
                                                "num_steps": 1})
    exp_dir = StrongRunner(device="cpu").train(config)
    log = (exp_dir / "train.log").read_text()
    assert "epoch: 1" in log and "samples/s" in log
    assert json.loads((exp_dir / "config.json").read_text())[
        "model"]["audio_encoder"]["type"] == "CrnnEncoder"
    assert [p.name for p in (exp_dir / "profile").iterdir()] == [
        "steps_1-1.json"]
    payload = load_checkpoint(exp_dir / "best.pth")
    model = BiEncoder(CrnnEncoder(), EmbeddingAgg(5221, 256), ExpNegL2(),
                      shared_dim=256, device="cpu")
    model.load_state_dict(payload["model"])                     # strict
    assert not payload["trainables_only"]
