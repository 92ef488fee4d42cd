"""The port's sentence-level WSTAG runner and the self-supervision runner
against the JAX package.

* The shipped configs ``configs/weak_sentence/{phrase,word}_wise/*.yaml``
  and ``configs/weak_phrase/cnn8rnn_w2vmean_clustering_selfsup.yaml``
  build through the port's ``instantiate`` and train one step through
  ``WeakSentenceRunner`` / ``WeakPhraseSelfSupervisionRunner`` on the CPU
  (4 clips of 0.6 s from ``tests/synthetic.py``, text width 64, the
  full-width Cnn8Rnn); the self-supervision teacher loads a trainable-only
  checkpoint from ``teacher.checkpoint``, is bit for bit the same after
  the fit, and no checkpoint holds a key of it.
* One train step of each runner's model (phrase-wise
  ``AudioTextAlignByPhrase`` + ``MaxMarginRankingLoss``; a
  ``MultiTextBiEncoder`` student under a teacher with
  ``ClipFrameBceLoss``), dropout off, against JAX's step on the same
  weights and batch (the JAX step jitted in two parts: the Cnn8Rnn tower's
  forward and backward, one compile shared by both steps, and the rest
  over the tower's output).  The f32 limits (``PERF.md`` §2) with
  ``ROADMAP.md`` Queue 3's standing properties: the loss within rtol
  1e-5, the running statistics within 1e-5 (and 1e-6 relative: bn0's
  variances are log-mel dB squared, ~300), each gradient by relative RMS
  within 2e-2 in the conv trunk and 1e-4 after it, or within twice the
  larger of the two packages' own change when the waveform is scaled by
  1 + 1e-6 where that is larger (the step is ill-conditioned: batch 2,
  1 s, train-mode BN).
* Word-wise ``eval_inference`` (``word_aggregation`` mean) gives JAX's
  score tracks within 1e-5 on the same weights (JAX's runner forward over
  the module's one compile of the tower), and JAX's metrics within 1e-9
  (the port's ``_report_metrics`` on its buffers, JAX's metric functions
  as its runner calls them on its own).
* The shipped phrase-wise eval config raises ``KeyError: 'phrases'`` in
  both packages; a teacher config with only ``pretrained`` loads no
  checkpoint in either.

The JAX metric functions run on their NumPy paths (the JAX package's
native library builds in place and must not be raced).
"""

import json
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.synthetic import make_grounding_data, make_vocab
from tests.test_torch_port_align import (
    _TRUNK,
    _phrase_batch,
    jax_forward,
    jax_variables,
)
from tests.test_torch_port_train import _rel_rms
from texttoaudiogrounding_tpu import native as jnative
from texttoaudiogrounding_tpu.data import collate as jcollate
from texttoaudiogrounding_tpu.data import datasets as jdatasets
from texttoaudiogrounding_tpu.data.tokenizer import DictTokenizer as JTok
from texttoaudiogrounding_tpu.evaluation.psds import (
    compute_psds_sed_scores as j_psds,
)
from texttoaudiogrounding_tpu.evaluation.th_auc import (
    compute_th_auc as j_th_auc,
)
from texttoaudiogrounding_tpu.training.runner_base import (
    array_batch,
    upcast_wire,
)
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    WeakPhraseSelfSupervisionRunner as JSelfSupRunner,
)
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    weak_output_transform as j_weak_transform,
)
from texttoaudiogrounding_tpu.training.runner_weak_sentence import (
    WeakSentenceRunner as JSentenceRunner,
)
from texttoaudiogrounding_tpu.training.torch_import import import_biencoder
from texttoaudiogrounding_tpu.training.train_state import TrainState
from texttoaudiogrounding_tpu.utils import registry as jregistry
from texttoaudiogrounding_tpu_torch import (
    from_jax_variables,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
    WeakPhraseSelfSupervisionRunner,
    weak_output_transform,
)
from texttoaudiogrounding_tpu_torch.training.runner_weak_sentence import (
    WeakSentenceRunner,
)
from texttoaudiogrounding_tpu_torch.training.train_state import (
    save_checkpoint,
)
from texttoaudiogrounding_tpu_torch.utils.config import load_config
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

CPU = torch.device("cpu")
_WIDTH = 64
SENTENCE = "configs/weak_sentence/{}/{}.yaml"
SELFSUP = "configs/weak_phrase/cnn8rnn_w2vmean_clustering_selfsup.yaml"
_CONFIGS = {"phrase_wise": SENTENCE.format(
                "phrase_wise", "cnn8rnn_w2vmean_dp_amean_tmean"),
            "word_wise": SENTENCE.format("word_wise",
                                         "cnn8rnn_w2v_dp_amean_tmean"),
            "selfsup": SELFSUP}


@pytest.fixture(scope="module", autouse=True)
def one_thread_numpy_metrics_no_dropout():
    """One intra-op thread for the small CPU models, the JAX metrics on
    their NumPy paths, and flax's dropout the identity (the port's is off
    in each model's config)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "get_lib", lambda: None)
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    yield
    mp.undo()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """4 clips of 0.6 s in the grounding label JSON's layout (the caption
    datasets read it), the same with string phrases (the WSTAG sampler's
    layout), a vocabulary, a 2-cluster map and the duration TSV."""
    root = tmp_path_factory.mktemp("sentence")
    wav, label, duration = make_grounding_data(
        root, num_audio=4, duration=0.6, max_phrases=2, seed=9,
        event_len=(0.1, 0.2))
    n_vocab = len(make_vocab(label, root / "vocab.pkl"))
    items = json.loads(label.read_text())
    (root / "caps.json").write_text(json.dumps([
        {**it, "phrases": [p["phrase"] for p in it["phrases"]]}
        for it in items]))
    phrases = sorted({p["phrase"] for it in items for p in it["phrases"]})
    (root / "clusters.json").write_text(json.dumps(
        {"0": phrases[::2], "1": phrases[1::2]}))
    (root / "audio.csv").write_text(wav.read_text().replace(
        "hdf5_path", "file_path"))
    return {"root": root, "wav": str(wav), "label": str(label),
            "caps": str(root / "caps.json"), "audio": str(root / "audio.csv"),
            "clusters": str(root / "clusters.json"),
            "vocab": str(root / "vocab.pkl"), "n_vocab": n_vocab,
            "duration": str(duration)}


def _tiny(model: dict, data: dict) -> dict:
    """The config's model with text width 64 (the projections then map
    both towers to the shared width 64) and the test vocabulary."""
    model["args"]["shared_dim"] = _WIDTH
    model["text_encoder"]["args"].update(vocab_size=data["n_vocab"],
                                         embed_dim=_WIDTH)
    return model


def _config(name: str, data: dict, exp_dir) -> dict:
    """A shipped training config cut to the test data: batches of 2, one
    step an epoch, one epoch, the tiny model."""
    cfg = load_config(_CONFIGS[name])
    cfg["experiment_path"] = str(exp_dir)
    cfg["trainer"].update(epochs=1, epoch_length=1, save_interval=1)
    for split in ("train", "val"):
        loader = cfg["data"][split]
        args = loader["dataset"]["args"]
        if name == "selfsup":
            args.update(audio=data["audio"], label=data["caps"],
                        phrase_num=3, cluster_map=data["clusters"],
                        max_audio_length=0.6)
        else:
            args.update(waveform=data["wav"], label=data["label"])
        loader["collate_fn"]["args"]["tokenizer"]["args"]["vocabulary"] = \
            data["vocab"]
        loader["dataloader_args"] = {"batch_size": 2}
    _tiny(cfg["model"], data)
    if name == "selfsup":
        _tiny(cfg["teacher"], data)
    return cfg


def _teacher_checkpoint(cfg: dict, path) -> dict:
    """A trainable-only checkpoint of the teacher's model (its embedding
    frozen, so left out); returns what it holds."""
    model = instantiate(cfg["teacher"], device="cpu")
    model.load_state_dict(random_state_dict(model, seed=21))
    frozen = "text_encoder.embedding.core.weight"
    save_checkpoint(path, model, None, None, 1, {}, 0, include_optim=False,
                    save_trainable_only=True,
                    trainable_mask={k: k != frozen
                                    for k in model.state_dict()})
    return torch.load(path, weights_only=True)["model"]


@pytest.fixture(scope="module")
def trained(data):
    """Each shipped config trained one step on the CPU: name → (runner,
    experiment directory)."""
    out = {}
    for name in _CONFIGS:
        cfg = _config(name, data, data["root"] / f"exp_{name}")
        if name == "selfsup":
            teacher_sd = _teacher_checkpoint(cfg, data["root"] / "teacher.pth")
            cfg["teacher"]["checkpoint"] = str(data["root"] / "teacher.pth")
            runner = WeakPhraseSelfSupervisionRunner(device="cpu")
        else:
            runner = WeakSentenceRunner(device="cpu")
        out[name] = (runner, runner.train(cfg))
        if name == "selfsup":
            out["teacher_sd"] = teacher_sd
    return out


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_shipped_config_trains_through_the_port(trained, name):
    runner, exp_dir = trained[name]
    for file in ("best.pth", "last.pth", "config.json", "train.log"):
        assert (exp_dir / file).is_file(), file
    ckpt = torch.load(exp_dir / "best.pth", weights_only=True)
    assert ckpt["save_trainable_only"] and ckpt["epoch"] == 1
    model = runner.build_model()
    assert set(ckpt["model"]) == set(model.state_dict())
    assert all(torch.isfinite(v).all() for v in ckpt["model"].values()
               if v.is_floating_point())
    if name == "selfsup":              # the teacher: loaded, untouched
        teacher = runner.teacher.state_dict()
        for key, value in trained["teacher_sd"].items():
            assert torch.equal(teacher[key], value), key
        assert all(not p.requires_grad for p in runner.teacher.parameters())
        assert not runner.teacher.training


def test_teacher_with_only_pretrained_loads_nothing(data, tmp_path):
    cfg = _config("selfsup", data, tmp_path)
    cfg["teacher"]["pretrained"] = str(tmp_path / "missing" / "best")
    jrunner = JSelfSupRunner()
    jrunner.setup(json.loads(json.dumps(cfg)))
    assert jrunner.build_teacher()[1] is None       # JAX: no checkpoint
    runner = WeakPhraseSelfSupervisionRunner(device="cpu")
    runner.setup(cfg)
    torch.manual_seed(5)
    teacher = runner.build_teacher()
    torch.manual_seed(5)
    fresh = instantiate(cfg["teacher"], device="cpu")
    for key, value in fresh.state_dict().items():
        assert torch.equal(teacher.state_dict()[key], value), key


def test_phrase_wise_eval_config_raises_in_both_packages(trained, data):
    eval_cfg = load_config("configs/weak_sentence/phrase_wise/eval.yaml")
    test = eval_cfg["data"]["test"]
    test["dataset"]["args"].update(waveform=data["wav"],
                                   label=data["label"])
    test["collate_fn"]["args"]["tokenizer"]["args"]["vocabulary"] = \
        data["vocab"]
    test["duration"] = data["duration"]
    with pytest.raises(KeyError, match="phrases"):
        WeakSentenceRunner(device="cpu").evaluate(trained["phrase_wise"][1],
                                                  eval_cfg)
    args = test["dataset"]["args"]
    items = jdatasets.AudioPhraseEvalDataset(args["waveform"], args["label"])
    batch = array_batch(jcollate.TextCollate(
        JTok(data["vocab"]), **{k: v for k, v in test["collate_fn"][
            "args"].items() if k != "tokenizer"})([items[0], items[1]]))
    assert "phrases" not in batch and "text" in batch
    jmodel = jregistry.instantiate(_tiny(load_config(
        _CONFIGS["phrase_wise"])["model"], data))
    with pytest.raises(KeyError, match="phrases"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), batch))


def _paths(node, cuts: tuple, prefix: str = "") -> dict:
    """Every leaf of a nested dict as ``dotted.path -> value``; a path in
    ``cuts`` is a leaf."""
    if not isinstance(node, dict) or prefix[:-1] in cuts:
        return {prefix[:-1]: node}
    out = {}
    for key, value in node.items():
        out.update(_paths(value, cuts, f"{prefix}{key}."))
    return out


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_chip_smoke_configs_are_the_yaml(name, tmp_path):
    """``chip_smoke.py``'s configs of the new phases differ from the
    shipped YAML files in the keys its ``*_CUTS`` constants list only."""
    if name == "selfsup":
        cuts = chip_smoke.SELFSUP_CUTS
        got = chip_smoke._selfsup_config(tmp_path, tmp_path / "best.pth")
        epochs = chip_smoke.SENTENCE_EPOCHS
    else:
        cuts = chip_smoke.SENTENCE_CUTS
        words = name == "word_wise"
        epochs = chip_smoke.WORD_EPOCHS if words else \
            chip_smoke.SENTENCE_EPOCHS
        got = chip_smoke._sentence_config(
            "exp", "AudioTextAlignBy" + ("Word" if words else "Phrase"),
            chip_smoke._sentence_data(Path(tmp_path), words), epochs)
    want, got = _paths(load_config(_CONFIGS[name]), cuts), _paths(got, cuts)
    differ = {k for k in set(want) | set(got)
              if k not in want or k not in got or got[k] != want[k]}
    assert differ == set(cuts)
    assert got["trainer.epochs"] == epochs
    assert got["trainer.epoch_length"] == chip_smoke.SENTENCE_STEPS


# --------------------------------------------------------- train steps
@jax.jit
def _jax_trunk_step(params, stats, waves, cotangent):
    """The Cnn8Rnn tower in train mode: (output, running statistics, the
    parameters' gradient under ``cotangent`` on the embedding)."""
    def tower(p):
        out, mut = _TRUNK.apply({"params": p, "batch_stats": stats}, waves,
                                train=True, mutable=["batch_stats"])
        return out["embedding"], (out, mut)
    _, vjp, (out, mut) = jax.vjp(tower, params, has_aux=True)
    return out, mut["batch_stats"], vjp(cotangent)[0]


def _jax_step(jmodel, variables, batch, loss_of):
    """JAX's train step in two jitted parts: the tower, then the rest over
    its output, whose gradient to the embedding goes back through the
    tower.  Returns (loss, the port-named gradients and running
    statistics)."""
    params = dict(variables["params"])
    trunk_p = params.pop("audio_encoder")
    stats = variables["batch_stats"]["audio_encoder"]
    waves = {k: batch[k] for k in ("waveform", "waveform_len")}
    out, new_stats, _ = _jax_trunk_step(trunk_p, stats, waves,
                                        np.zeros((2, 25, 512), np.float32))

    def rest(head_p, emb, b):
        def take(f, args, kwargs, ctx):
            if ctx.method_name == "__call__" and \
                    ctx.module.name == "audio_encoder":
                return {"embedding": emb, "length": out["length"]}
            return f(*args, **kwargs)
        with fnn.intercept_methods(take):
            o = jmodel.apply({"params": {**head_p, "audio_encoder": trunk_p},
                              "batch_stats": variables["batch_stats"]}, b,
                             train=True, mutable=["batch_stats"])[0]
        return loss_of(o, b)

    loss, (g_head, g_emb) = jax.jit(jax.value_and_grad(
        rest, argnums=(0, 1)))(params, out["embedding"], batch)
    _, _, g_trunk = _jax_trunk_step(trunk_p, stats, waves, g_emb)
    grads = {**g_head, "audio_encoder": g_trunk}
    ref = from_jax_variables(jax.tree.map(np.asarray, {
        "params": grads, "batch_stats": {"audio_encoder": new_stats}}))
    return float(loss), ref


def _port_step(model, batch, loss_of):
    model.zero_grad(set_to_none=True)
    model.train()
    loss = loss_of(model, to_device(batch, CPU))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


def _scaled(batch: dict) -> dict:
    return {**batch, "waveform": (batch["waveform"] * np.float32(1 + 1e-6))
            .astype(np.float32)}


def _held(jmodel, model, variables, batch, jloss_of, loss_of) -> None:
    jloss, ref = _jax_step(jmodel, variables, batch, jloss_of)
    _, ref_s = _jax_step(jmodel, variables, _scaled(batch), jloss_of)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    loss, grads = _port_step(model, batch, loss_of)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    model.load_state_dict(sd)
    _, grads_s = _port_step(model, _scaled(batch), loss_of)
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert set(grads) <= set(ref)
    worst = [0.0, 0.0]
    for name, g in grads.items():
        own = max(_rel_rms(grads_s[name].numpy(), g.numpy()),
                  _rel_rms(ref_s[name].numpy(), ref[name].numpy()))
        rel = _rel_rms(g.numpy(), ref[name].numpy())
        trunk = "conv_block" in name or "bn0" in name
        assert rel <= max(2 * own, 2e-2 if trunk else 1e-4), (
            name, rel, own)
        worst[trunk] = max(worst[trunk], rel)
    print("worst relative RMS (rest, trunk):", worst)
    for name, value in stats.items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=1e-5, err_msg=name)


def _models(model_cfg: dict, batch: dict, seed: int) -> tuple:
    jmodel = jregistry.instantiate(model_cfg)
    model = instantiate(model_cfg, device="cpu")
    model.audio_encoder.dropout = (0.0, 0.0)
    return jmodel, model, jax_variables(jmodel, batch, model, seed)


def test_sentence_train_step_matches_jax(data):
    from texttoaudiogrounding_tpu.losses import MaxMarginRankingLoss as JMMR

    from texttoaudiogrounding_tpu_torch.losses import MaxMarginRankingLoss
    cfg = _tiny(load_config(_CONFIGS["phrase_wise"])["model"], data)
    cfg["text_encoder"]["args"]["vocab_size"] = 60
    batch = _phrase_batch(np.random.default_rng(12))
    jmodel, model, variables = _models(cfg, batch, seed=13)
    loss_fn, jloss_fn = MaxMarginRankingLoss(), JMMR()
    _held(jmodel, model, variables, batch,
          lambda o, b: jloss_fn(j_weak_transform(o, b)),
          lambda m, b: loss_fn(weak_output_transform(m(b), b)))


def test_self_supervision_train_step_matches_jax(data):
    from texttoaudiogrounding_tpu.losses import ClipFrameBceLoss as JLoss

    from texttoaudiogrounding_tpu_torch.losses import ClipFrameBceLoss
    cfg = _tiny(load_config(_CONFIGS["selfsup"])["model"], data)
    rng = np.random.default_rng(14)
    text_len = rng.integers(1, 4, (2, 3)).astype(np.int32)
    text = rng.integers(2, data["n_vocab"], (2, 3, 3)).astype(np.int32)
    text[np.arange(3)[None, None, :] >= text_len[..., None]] = 0
    batch = {"waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(
        np.float32), "waveform_len": np.array([32000, 24000], np.int32),
        "text": text, "text_len": text_len,
        "label": np.array([[1, 1, 0], [1, 0, 0]], np.float32)}
    jmodel, model, variables = _models(cfg, batch, seed=15)
    jteacher, teacher, tvars = _models(cfg, batch, seed=16)
    teacher.eval().requires_grad_(False)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    t_out = jax_forward(jteacher, tvars, batch)
    keys = {"frame_weight": 0.5, "clip_label_key": "label",
            "frame_label_key": "frame_label"}
    loss_fn, jloss_fn = ClipFrameBceLoss(**keys), JLoss(**keys)
    transform = WeakPhraseSelfSupervisionRunner.teacher_transform(teacher)

    def jloss_of(o, b):
        return jloss_fn({**b, **o, "label": jnp.maximum(
            b["label"], t_out["clip_sim"]), "frame_label": t_out[
                "frame_sim"]})

    _held(jmodel, model, variables, batch, jloss_of,
          lambda m, b: loss_fn(transform(m(b), b)))
    for key, value in teacher.state_dict().items():
        assert torch.equal(value, before[key]), key
    with torch.no_grad():
        label = transform(model(to_device(batch, CPU)),
                          to_device(batch, CPU))["label"]
    assert (label >= torch.from_numpy(batch["label"])).all()


# ----------------------------------------------------------- evaluation
def test_word_wise_eval_inference_matches_jax(data, tmp_path, monkeypatch):
    eval_cfg = load_config("configs/weak_sentence/word_wise/eval.yaml")
    test = eval_cfg["data"]["test"]
    test["dataset"]["args"].update(waveform=data["wav"],
                                   label=data["label"])
    test["collate_fn"]["args"]["tokenizer"]["args"]["vocabulary"] = \
        data["vocab"]
    test["duration"] = data["duration"]
    test["dataloader_args"] = {"batch_size": 2}
    eval_cfg.update(n_thresholds=10, max_efprs=[None])
    config = {"seed": 1, "model": _tiny(load_config(
        _CONFIGS["word_wise"])["model"], data),
        "eval_config": {"n_thresholds": 10},
        "inference_args": {"window_size": 1, "time_resolution": 0.04,
                           "word_aggregation": "mean"}}
    runner = WeakSentenceRunner(device="cpu")
    runner.setup(json.loads(json.dumps(config)))
    model = runner.build_model()
    model.load_state_dict(random_state_dict(model, seed=17))
    variables = import_biencoder({k: v.numpy() for k, v in
                                  model.state_dict().items()})
    jrunner = JSentenceRunner()          # one device: no padding to 8
    jrunner.setup({**json.loads(json.dumps(config)),
                   "parallel": {"mesh": {"data": 1}}})
    # the runner's forward (the model with output_matrix, the f16 wire
    # upcast) over the tower compiled once for the module
    monkeypatch.setattr(jrunner, "make_forward", lambda m, output_matrix: (
        lambda state, b: jax_forward(
            m, {"params": state.params, "batch_stats": state.batch_stats},
            upcast_wire(b), output_matrix=output_matrix)))
    ref = jrunner.eval_inference(
        jrunner.build_dataloader(test, shuffle=False), jrunner.build_model(),
        TrainState(params=variables["params"],
                   batch_stats=variables["batch_stats"], opt_state=None,
                   step=0))
    got = runner.eval_inference(runner.build_dataloader(test, shuffle=False),
                                model)
    assert got["score_buffer"].keys() == ref["score_buffer"].keys()
    assert len(got["score_buffer"]) >= 4
    for fname, df in ref["score_buffer"].items():
        track = got["score_buffer"][fname]["fake_event"]
        # the padded batch's 25 frames, not cut to the clip's 15
        assert track.shape == (25,)
        np.testing.assert_allclose(track, df.fake_event, rtol=0, atol=1e-5)
    # JAX's metric functions as its runner calls them, without the files
    want = {"psds@None": j_psds(
        scores=ref["score_buffer"], ground_truth=ref["gt_dict"],
        duration=test["duration"], fname_to_aid=ref["fname_to_aid"],
        dtc_threshold=0.5, gtc_threshold=0.5, max_efpr=None)}
    gt = ref["gt_df"].drop(columns=["event_label", "audio_id"])
    for lo, hi in ((0.0, 1.0), (0.2, 0.8)):
        want[f"th_auc@{lo}-{hi}"] = j_th_auc(
            ref["pred_buffer"], gt, dtc_threshold=0.5, gtc_threshold=0.5,
            min_threshold=lo, max_threshold=hi)
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # TSVs only
    results = runner._report_metrics(got, eval_cfg, tmp_path / "port")
    assert results.keys() == want.keys()
    for key, value in want.items():
        assert abs(results[key] - value) <= 1e-9, key
