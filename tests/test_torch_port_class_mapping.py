"""The port's class-mapping slice against the JAX package: SpecAugment and
mixup, ``VarLenPadCollate``, the eight class-mapping datasets,
``AudioTagging``, the class-mapping runners' transforms, a weak train step
with both augmentations, the strong runner's evaluation and the tagging
average precision.

Same numpy inputs from a seed, and through ``from_jax_variables``
(strict) the same weights, go through both packages.  Tolerances:

* ``spec_augment``'s masks given JAX's drawn stripes, ``do_mixup``,
  ``_mixup_lambdas``, ``VarLenPadCollate``, the datasets' items and
  ``mapping_strong_output_transform``: exact (key for key, dtype for
  dtype, value for value; tensors' integers int64 here, int32 in JAX);
* ``AudioTagging``'s eval forward at the full Cnn8Rnn width on 1 s
  clips: 1e-4 relative RMS, as ``MultiTextBiEncoder`` is held;
* one weak class-mapping train step (``ClipBceLoss`` through
  ``mixup_output_transform``, batch 2 mixed into 1, SpecAugment on the
  same fixed stripes in both packages, dropout the identity): loss rtol
  1e-5, running statistics atol 1e-5 + rtol 1e-6 (bn0's variances are
  ~300), each gradient by relative RMS within 2e-2 in the conv trunk and
  1e-4 after it, or twice the larger of the two packages' own change under
  a 1 + 1e-6 waveform scaling where that is larger.  The JAX step is
  jitted once (weights and batch its arguments; an eager Cnn8Rnn step
  costs ~30 s of operation compiles): on this test's data its gradients
  lie within 1.6e-3 relative RMS of the eager step's in the conv trunk
  and 2.3e-6 after it, and the port's gaps to the two agree to 1e-4
  (trunk 1e-2 to 2e-2, after it 1e-6 to 4e-6);
* the class-mapping strong evaluation: score tracks within 1e-5 of JAX's
  ``ClassMappingStrongRunner.eval_inference``, metrics of both packages
  on the port's buffers within 1e-9;
* ``evaluate_tagging``: the per-class AP within 1e-12 of JAX's; the NumPy
  ``average_precision`` against scikit-learn within 1e-12, with ties and a
  class without a positive (0, JAX's ``.fillna(0)``).

The JAX functions run on their NumPy paths (the JAX package's native
library builds in place, which its own tests must not be raced on).
"""

import copy
import json
import pickle
import warnings
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from sklearn.cluster import KMeans
from sklearn.metrics import average_precision_score
from sklearn.preprocessing import LabelEncoder

import chip_smoke
from tests.synthetic import make_grounding_data
from tests.test_torch_port_align import jax_forward
from tests.test_torch_port_eval_runner import _to_jax
from tests.test_torch_port_train import _rel_rms
from texttoaudiogrounding_tpu import native as jnative
from texttoaudiogrounding_tpu.data import class_mapping as jcm
from texttoaudiogrounding_tpu.data.collate import (
    VarLenPadCollate as JVarLenPadCollate,
)
from texttoaudiogrounding_tpu.losses import ClipBceLoss as JClipBce
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import audio_encoder as jaudio_encoder
from texttoaudiogrounding_tpu.models.audio_text_model import (
    AudioTagging as JAudioTagging,
)
from texttoaudiogrounding_tpu.models.layers import do_mixup as jdo_mixup
from texttoaudiogrounding_tpu.models.layers import (
    spec_augment as jspec_augment,
)
from texttoaudiogrounding_tpu.training import runner_class_mapping as jrcm
from texttoaudiogrounding_tpu.training.runner_weak_phrase import (
    weak_output_transform as j_weak_output_transform,
)
from texttoaudiogrounding_tpu.training.torch_import import import_cnn8rnn
from texttoaudiogrounding_tpu.training.train_state import TrainState
from texttoaudiogrounding_tpu_torch import (
    from_jax_variables,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.data import class_mapping as tcm
from texttoaudiogrounding_tpu_torch.data.collate import VarLenPadCollate
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.evaluation.tagging import (
    average_precision,
)
from texttoaudiogrounding_tpu_torch.losses import ClipBceLoss
from texttoaudiogrounding_tpu_torch.models import AudioTagging, Cnn8Rnn
from texttoaudiogrounding_tpu_torch.models import audio_encoder
from texttoaudiogrounding_tpu_torch.models.layers import (
    do_mixup,
    spec_augment,
    spec_augment_stripes,
    stripe_keep,
)
from texttoaudiogrounding_tpu_torch.training import runner_class_mapping
from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
    ClassMappingStrongRunner,
    ClassMappingWeakRunner,
    mixup_output_transform,
)
from texttoaudiogrounding_tpu_torch.utils.config import load_config
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

CPU = torch.device("cpu")
_CLASSES = 3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU models: the suite
    runs in several worker processes on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_paths():
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "get_lib", lambda: None)
    yield
    mp.undo()


# ------------------------------------------------------- augmentations
@jax.jit
def _jax_spec_augment(key, x):
    """JAX ``spec_augment`` on ``x`` and the stripes it draws from ``key``
    (its own calls, ``layers.py:649-656``), in one compiled function."""
    b, t, m = x.shape
    keys = jax.random.split(key, 4)

    def draw(kd, kb, size, num, total):
        d = jax.random.randint(kd, (b, num), 0, size)
        lo = jax.random.randint(kb, (b, num), 0, jnp.maximum(total - d, 1))
        return lo, d

    return jspec_augment(key, x), {"time": draw(keys[0], keys[1], 64, 2, t),
                                   "freq": draw(keys[2], keys[3], 8, 2, m)}


@pytest.mark.parametrize("shape", [(3, 101, 64), (2, 7, 5)])
def test_spec_augment_masks_match_jax(shape):
    """The port's masks on JAX's drawn stripes zero exactly what JAX's
    ``spec_augment`` zeroes (also where a stripe is wider than the axis);
    the port's own draws follow the same law."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref, drawn = _jax_spec_augment(jax.random.PRNGKey(shape[0]),
                                   jnp.asarray(x))
    stripes = {k: tuple(torch.from_numpy(np.asarray(a, np.int64)) for a in v)
               for k, v in drawn.items()}
    got = spec_augment(torch.from_numpy(x), stripes)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any()
    gen = torch.Generator().manual_seed(0)
    b, t, m = shape
    for _ in range(20):
        stripes = spec_augment_stripes(gen, b, t, m)
        for (begin, width), size, total in ((stripes["time"], 64, t),
                                            (stripes["freq"], 8, m)):
            assert begin.shape == width.shape == (b, 2)
            assert ((width >= 0) & (width < size)).all()
            assert ((begin >= 0)
                    & (begin < torch.clamp_min(total - width, 1))).all()
    keep = stripe_keep(torch.tensor([[2, 0]]), torch.tensor([[3, 0]]), 6)
    assert keep.tolist() == [[True, True, False, False, False, True]]


def test_do_mixup_and_lambdas_match_jax():
    rng = np.random.default_rng(2)
    lam = rng.uniform(size=6).astype(np.float32)
    for shape in ((6,), (6, 5), (6, 7, 4)):
        x = rng.normal(size=shape).astype(np.float32)
        ref = np.asarray(jdo_mixup(jnp.asarray(x), jnp.asarray(lam)))
        got = do_mixup(torch.from_numpy(x), torch.from_numpy(lam)).numpy()
        assert got.shape == (3,) + shape[1:]
        np.testing.assert_array_equal(got, ref)
    length = torch.tensor([25.0, 16.0])
    mixed = do_mixup(length, torch.tensor([0.4, 0.6]))
    assert mixed.dtype == torch.float32
    assert mixed.item() == pytest.approx(19.6)
    jrng, trng = np.random.RandomState(1235), np.random.RandomState(1235)
    for b in (32, 16, 7, 1, 32):
        ref = jrcm._mixup_lambdas(jrng, b)
        got = runner_class_mapping._mixup_lambdas(trng, b)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_float_length_keeps_its_frames_in_the_pooling():
    """A mixed length of 12.6 keeps 13 frames in the MIL pooling of both
    packages."""
    from texttoaudiogrounding_tpu.ops import masking as jmasking
    from texttoaudiogrounding_tpu_torch.ops import masking

    x = np.random.default_rng(3).uniform(0.1, 1, (2, 20, 3)).astype(
        np.float32)
    lens = np.array([12.6, 20.0], np.float32)
    ref = np.asarray(jmasking.linear_softmax_with_lens(jnp.asarray(x),
                                                       jnp.asarray(lens)))
    got = masking.linear_softmax_with_lens(torch.from_numpy(x),
                                           torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    cut = masking.linear_softmax_with_lens(
        torch.from_numpy(x[:, :13]), torch.tensor([13, 20])[:1].repeat(2))
    np.testing.assert_allclose(got[0], cut[0].numpy(), rtol=1e-6)


# --------------------------------------------------------------- collate
def _collate_items():
    rng = np.random.default_rng(4)
    items = []
    for i, n in enumerate((7, 12, 3, 9)):
        items.append({"audiocap_id": 100 + i, "audio_id": f"a{i}",
                      "text": f"w{i} w{i + 1}",
                      "waveform": rng.normal(size=n).astype(np.float32),
                      "strong_label": (rng.uniform(size=(n // 2 + 1, 3))
                                       > 0.5).astype(np.float32),
                      "label": rng.uniform(size=3).astype(np.float32),
                      "text_idx": int(i % 3), "score": float(i) / 3})
    return items


_COLLATES = {
    "pad": {"pad_keys": ["waveform", "strong_label"]},
    "buckets": {"pad_keys": ["waveform", "strong_label"],
                "pad_buckets": {"waveform": 8, "strong_label": 4}},
    "sorted_pad_to": {"pad_keys": ["waveform", "strong_label"],
                      "sort_key": "waveform",
                      "pad_to": {"waveform": 10}},
}


@pytest.mark.parametrize("case", list(_COLLATES))
def test_var_len_pad_collate_matches_jax(case):
    items = _collate_items()
    ref = JVarLenPadCollate(**_COLLATES[case])(copy.deepcopy(items))
    got = VarLenPadCollate(**_COLLATES[case])(copy.deepcopy(items))
    _assert_same_item(got, ref)


def _assert_same_item(got: dict, ref: dict) -> None:
    assert list(got) == list(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert isinstance(got[key], np.ndarray), key
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert type(got[key]) is type(value), key
            assert got[key] == value, key


# -------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def mapping_files(tmp_path_factory):
    """Six 1 s clips in HDF5 (``tests/synthetic.py``), phrase and class
    embedding pickles, a pickled ``LabelEncoder``, AudioSet tags, a
    k-means model dumped with joblib and a cluster-map JSON."""
    root = tmp_path_factory.mktemp("class_mapping")
    wav_csv, label_json, dur_csv = make_grounding_data(
        root, num_audio=6, duration=1.0, seed=5, max_phrases=3)
    items = json.loads(label_json.read_text())
    phrases = sorted({p["phrase"] for it in items for p in it["phrases"]})
    rng = np.random.default_rng(6)
    pemb = {p: rng.normal(size=8).astype(np.float32) for p in phrases}
    classes = ["Bird", "Dog", "Speech", "Water"]
    lemb = {c: rng.normal(size=8).astype(np.float32) for c in classes}
    for name, obj in (("pemb.pkl", pemb), ("lemb.pkl", lemb),
                      ("le.pkl", LabelEncoder().fit(classes))):
        with open(root / name, "wb") as f:
            pickle.dump(obj, f)
    with open(root / "as_label.tsv", "w") as f:
        f.write("audio_id\tevent_labels\n")
        for i, it in enumerate(items):
            f.write(f"{it['audio_id']}\t{classes[i % 4]};Speech\n")
    km = KMeans(n_clusters=_CLASSES, n_init=3, random_state=0).fit(
        np.stack([pemb[p] for p in phrases]))
    joblib.dump(km, root / "km.joblib")
    (root / "cmap.json").write_text(json.dumps(
        {str(i): phrases[i::_CLASSES] for i in range(_CLASSES)}))
    return {"root": root, "wav": str(wav_csv), "label": str(label_json),
            "dur": str(dur_csv)}


def _files(f: dict, *names) -> dict:
    paths = {"phrase_embed": "pemb.pkl", "as_label_embed": "lemb.pkl",
             "label_encoder": "le.pkl", "audioset_label": "as_label.tsv",
             "cluster_model": "km.joblib", "cluster_map": "cmap.json"}
    return {n: str(f["root"] / paths[n]) for n in names}


_AS = ("phrase_embed", "as_label_embed")
_AS_WEAK = _AS + ("audioset_label", "label_encoder")
_DATASETS = {
    "ASMappingEvalDataset": ("ASMappingEvalDataset", _AS, {}),
    "ASMappingWeakDataset_window": (
        "ASMappingWeakDataset", _AS_WEAK,
        {"thresholds": [0.0, 0.9], "topk": 2, "max_audio_length": 0.5}),
    "ASMappingWeakDataset_percentile": (
        "ASMappingWeakDataset", _AS_WEAK,
        {"thresholds": None, "min_sim_percent": 50.0,
         "use_audioset_label": False, "max_phrase_words": 1}),
    "ASMappingEvalLabelSimDataset": ("ASMappingEvalLabelSimDataset", _AS,
                                     {}),
    "ASMappingStrongDataset": (
        "ASMappingStrongDataset", _AS_WEAK,
        {"thresholds": [-0.2, 1.0], "topk": 0, "time_resolution": 0.04}),
    "KmeansMappingEvalDataset": ("KmeansMappingEvalDataset",
                                 ("phrase_embed", "cluster_model"), {}),
    "KmeansMappingDataset_weak": (
        "KmeansMappingDataset", ("phrase_embed", "cluster_model"),
        {"max_dist_percent": 60.0, "max_audio_length": 0.5, "seed": 3}),
    "KmeansMappingDataset_strong": (
        "KmeansMappingDataset", ("phrase_embed", "cluster_model"),
        {"label_type": "strong", "time_resolution": 0.04}),
    "SpectralMappingEvalDataset": ("SpectralMappingEvalDataset",
                                   ("cluster_map",), {}),
    "SpectralMappingDataset_weak": (
        "SpectralMappingDataset", ("cluster_map",),
        {"max_audio_length": 0.75, "no_waveform": False}),
    "SpectralMappingDataset_strong": (
        "SpectralMappingDataset", ("cluster_map",),
        {"label_type": "strong", "no_waveform": True}),
}


@pytest.mark.parametrize("case", list(_DATASETS))
def test_class_mapping_dataset_matches_jax(mapping_files, case):
    name, files, args = _DATASETS[case]
    kwargs = {"waveform": mapping_files["wav"],
              "label": mapping_files["label"],
              **_files(mapping_files, *files), **args}
    ref_ds = getattr(jcm, name)(**kwargs)
    got_ds = getattr(tcm, name)(**kwargs)
    assert len(got_ds) == len(ref_ds) > 0
    for salt in (None, 7):
        if salt is not None:
            ref_ds.reseed(salt)
            getattr(got_ds, "reseed", lambda s: None)(salt)
        for i in range(len(ref_ds)):
            _assert_same_item(got_ds[i], ref_ds[i])
    assert hasattr(got_ds, "reseed") == hasattr(ref_ds, "rng")


# ----------------------------------------------------------------- model
def _batch(classes: int = _CLASSES) -> dict:
    rng = np.random.default_rng(11)
    return {"waveform": (rng.normal(size=(2, 32000)) * 0.1).astype(
                np.float32),
            "waveform_len": np.array([32000, 21000], np.int32),
            "label": np.array([[1, 0, 1], [0, 1, 0]], np.float32)[:, :classes]}


@pytest.fixture(scope="module")
def tagging():
    """(JAX AudioTagging, its variables, the port model holding them)."""
    batch = _batch()
    jmodel = JAudioTagging(audio_encoder=JCnn8Rnn(sample_rate=32000),
                           classes_num=_CLASSES)
    model = AudioTagging(Cnn8Rnn(dropout=(0.0, 0.0)), _CLASSES,
                         device="cpu")
    return jmodel, tagging_variables(model, seed=21), model


def tagging_variables(model, seed: int) -> dict:
    """JAX ``AudioTagging`` variables from the port's random weights
    (``import_cnn8rnn`` for the tower, ``fc_output`` transposed), loaded
    into ``model`` strictly through ``from_jax_variables``."""
    sd = {k: v.numpy() for k, v in random_state_dict(model,
                                                     seed=seed).items()}
    tower = import_cnn8rnn(sd, prefix="audio_encoder.")
    variables = jax.tree.map(np.asarray, {
        "params": {"audio_encoder": tower["params"],
                   "fc_output": {"kernel": sd["fc_output.weight"].T.copy(),
                                 "bias": sd["fc_output.bias"]}},
        "batch_stats": {"audio_encoder": tower["batch_stats"]}})
    model.load_state_dict(from_jax_variables(variables))     # strict
    return variables


def test_audio_tagging_forward_matches_jax(tagging):
    jmodel, variables, model = tagging
    batch = _batch()
    ref = jax_forward(jmodel, variables, batch)
    model.eval()
    with torch.no_grad():
        out = model(to_device(batch, CPU))
    assert out["frame_sim"].shape == ref["frame_sim"].shape == (2, 25,
                                                                _CLASSES)
    assert out["clip_sim"].shape == (2, _CLASSES)
    np.testing.assert_array_equal(out["length"].numpy(),
                                  np.asarray(ref["length"]))
    for key in ("frame_sim", "clip_sim"):
        rel = _rel_rms(out[key].numpy(), np.asarray(ref[key]))
        assert rel <= 1e-4, (key, rel)
    sd = from_jax_variables(variables)
    assert sorted(sd) == sorted(model.state_dict())
    assert sd["fc_output.weight"].shape == (_CLASSES, 512)


def test_mapping_strong_output_transform_matches_jax():
    rng = np.random.default_rng(12)
    out = {"frame_sim": rng.uniform(size=(2, 9, 3)).astype(np.float32),
           "clip_sim": rng.uniform(size=(2, 3)).astype(np.float32),
           "length": np.array([9, 0], np.int64)}
    cases = [{"strong_label": rng.uniform(size=(2, 12, 3)) > 0.5,
              "weak_label": np.ones((2, 3), np.float32)},
             {"strong_label": (rng.uniform(size=(2, 6, 3)) > 0.5).astype(
                 np.float32),
              "strong_label_mask": np.ones((2, 3), np.float32)},
             {"label": np.ones((2, 3), np.float32)}]
    for batch in cases:
        ref = jrcm.mapping_strong_output_transform(
            {k: jnp.asarray(v) for k, v in out.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})
        got = runner_class_mapping.mapping_strong_output_transform(
            {k: torch.from_numpy(v) for k, v in out.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        assert sorted(got) == sorted(ref)
        for key, value in ref.items():
            value = np.asarray(value)         # int32 in JAX, int64 here
            assert got[key].numpy().dtype.kind == value.dtype.kind, key
            np.testing.assert_array_equal(got[key].numpy(), value,
                                          err_msg=key)


# ------------------------------------------------------------- train step
_STRIPES = {"time": ([[3, 14], [0, 20]], [[5, 2], [0, 40]]),
            "freq": ([[7, 50], [1, 30]], [[3, 6], [0, 7]])}


def _keep(axis: str, total: int) -> np.ndarray:
    begin, width = (np.array(a)[..., None] for a in _STRIPES[axis])
    idx = np.arange(total)[None, None]
    return ~((idx >= begin) & (idx < begin + width)).any(axis=1)


def _step_batch(scale: float = 1.0) -> dict:
    batch = _batch()
    batch["waveform"] = (batch["waveform"] * np.float32(scale)).astype(
        np.float32)
    batch["mixup_lambda"] = jrcm._mixup_lambdas(np.random.RandomState(1235),
                                                2)
    return batch


def _jax_weak_step(jmodel, variables: dict, batches: list) -> list:
    """JAX's weak class-mapping step (dropout the identity, SpecAugment
    on ``_STRIPES``, the runner's label mixing), jitted once over the
    weights and the batch: (loss, port-named gradients and running
    statistics) a batch."""
    tkeep = jnp.asarray(_keep("time", 101), jnp.float32)
    fkeep = jnp.asarray(_keep("freq", 64), jnp.float32)

    def step(params, stats, batch):
        def loss_of(p):
            out, mut = jmodel.apply(
                {"params": p, "batch_stats": stats},
                {**batch, "specaug": True}, train=True,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1),
                      "specaug": jax.random.PRNGKey(2)})
            merged = j_weak_output_transform(out, batch)
            merged["label"] = jdo_mixup(batch["label"],
                                        batch["mixup_lambda"])
            return JClipBce()(merged), mut
        return jax.value_and_grad(loss_of, has_aux=True)(params)

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jaudio_encoder, "spec_augment",
                   lambda key, x: x * tkeep[:, :, None] * fkeep[:, None, :])
        fn = jax.jit(step)
        for batch in batches:
            (loss, mut), grads = fn(variables["params"],
                                    variables["batch_stats"], batch)
            out.append((float(loss), from_jax_variables(jax.tree.map(
                np.asarray, {"params": grads,
                             "batch_stats": mut["batch_stats"]}))))
    return out


def _port_weak_step(model, sd: dict, batch: dict) -> tuple:
    """The port's step on the same weights and stripes: (loss, the model
    after the backward)."""
    model.load_state_dict(sd)
    model.zero_grad(set_to_none=True)
    model.train()
    stripes = {k: (torch.tensor(b), torch.tensor(w))
               for k, (b, w) in _STRIPES.items()}
    tb = to_device(batch, CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(audio_encoder, "spec_augment_stripes",
                   lambda gen, b, t, m: stripes)
        loss = ClipBceLoss()(mixup_output_transform(
            model({**tb, "specaug": True}), tb))
    loss.backward()
    model.eval()
    return loss.item(), model


def _is_trunk(name: str) -> bool:
    return "conv_block" in name or "bn0" in name


def test_weak_class_mapping_step_matches_jax(tagging):
    jmodel, variables, model = tagging
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [_step_batch(), _step_batch(1 + 1e-6)]
    (jloss, ref), (_, ref_s) = _jax_weak_step(jmodel, variables, batches)
    loss_s, model_s = _port_weak_step(model, sd, batches[1])
    grads_s = {n: p.grad.clone() for n, p in model_s.named_parameters()}
    loss, model = _port_weak_step(model, sd, batches[0])
    assert loss == pytest.approx(jloss, rel=1e-5)
    params = list(model.named_parameters())
    assert sum(_is_trunk(n) for n, _ in params) == 26 and len(params) == 38
    for name, p in params:
        own = max(_rel_rms(grads_s[name].numpy(), p.grad.numpy()),
                  _rel_rms(ref_s[name].numpy(), ref[name].numpy()))
        bound = max(2 * own, 2e-2 if _is_trunk(name) else 1e-4)
        rel = _rel_rms(p.grad.numpy(), ref[name].numpy())
        assert rel <= bound, (name, rel, own)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                       rtol=1e-6, atol=1e-5, err_msg=name)
    model.load_state_dict(sd)


# ------------------------------------------------------------ runners
def _config(f: dict, exp_dir, label_type: str) -> dict:
    """A class-mapping config on ``mapping_files`` (the k-means datasets,
    ``configs/class_mapping`` collates)."""
    data = {"type": "KmeansMappingDataset", "args": {
        "waveform": f["wav"], "label": f["label"],
        **_files(f, "phrase_embed", "cluster_model"),
        "label_type": label_type, "time_resolution": 0.04,
        "max_dist_percent": 100.0}}
    pad = (["waveform", "strong_label"] if label_type == "strong"
           else ["waveform"])
    loader = {"dataset": data, "collate_fn": {
        "type": "VarLenPadCollate",
        "args": {"pad_keys": pad, "pad_buckets": {"waveform": 32000,
                                                  "strong_label": 100}}},
        "dataloader_args": {"batch_size": 4}}
    return {"experiment_path": str(exp_dir), "seed": 1,
            "mixup": label_type == "weak", "specaug": label_type == "weak",
            # the JAX runners on one device (the port reads no "parallel")
            "parallel": {"mesh": {"data": 1}},
            "data": {"train": loader, "val": loader},
            "model": {"type": "AudioTagging",
                      "args": {"classes_num": _CLASSES,
                               "pooling": "linear_softmax"},
                      "audio_encoder": {"type": "Cnn8Rnn",
                                        "args": {"sample_rate": 32000}}},
            "loss": {"type": "ClipBceLoss" if label_type == "weak"
                     else "MaskedFrameBceLoss", "args": {}}}


def _experiments(tagging, f: dict, root, label_type: str) -> tuple:
    """The same weights as a port run's directory (``config.json``,
    ``best.pth``) and a JAX run's ``config.yaml``; the JAX runner is given
    the weights by its ``restore_state`` (no orbax checkpoint)."""
    _, variables, _ = tagging
    port_dir, jax_dir = root / "port", root / "jax"
    for d in (port_dir, jax_dir):
        d.mkdir()
    config = _config(f, port_dir, label_type)
    (port_dir / "config.json").write_text(json.dumps(config))
    torch.save({"model": from_jax_variables(variables)},
               port_dir / "best.pth")
    with open(jax_dir / "config.yaml", "w") as w:
        yaml.safe_dump({**config, "experiment_path": str(jax_dir)}, w)
    return port_dir, jax_dir, config


def _jax_state(variables: dict) -> TrainState:
    return TrainState(params=variables["params"],
                      batch_stats=variables["batch_stats"], opt_state=None,
                      step=0)


def _eval_config(f: dict) -> dict:
    return {"resume": "best", "n_thresholds": 50, "window_size": 1,
            "time_resolution": 0.04, "max_efprs": [None],
            "output": "result.txt", "data": {"test": {
                "dataset": {"type": "KmeansMappingEvalDataset", "args": {
                    "waveform": f["wav"], "label": f["label"],
                    **_files(f, "phrase_embed", "cluster_model")}},
                "collate_fn": {"type": "VarLenPadCollate", "args": {
                    "pad_keys": ["waveform"],
                    "pad_buckets": {"waveform": 32000}}},
                "dataloader_args": {"batch_size": 4},
                "duration": f["dur"]}}}


def test_class_mapping_strong_evaluation_matches_jax(
        tagging, mapping_files, tmp_path, monkeypatch):
    port_dir, _, config = _experiments(tagging, mapping_files, tmp_path,
                                       "strong")
    eval_cfg = _eval_config(mapping_files)
    runner = ClassMappingStrongRunner(device="cpu")
    _, _, model, loader = runner._load_for_eval(port_dir, eval_cfg)
    got = runner.eval_inference(loader, model)

    jrunner = jrcm.ClassMappingStrongRunner()
    jrunner.setup(copy.deepcopy(config))
    jrunner.config["eval_config"] = {"n_thresholds": 50}
    jrunner.config["inference_args"] = {"window_size": 1}
    _, variables, _ = tagging
    ref = jrunner.eval_inference(
        jrunner.build_dataloader(eval_cfg["data"]["test"], shuffle=False),
        jrunner.build_model(), _jax_state(variables))
    assert got["score_buffer"].keys() == ref["score_buffer"].keys()
    assert len(got["score_buffer"]) >= 6
    for fname, track in ref["score_buffer"].items():
        mine = got["score_buffer"][fname]["fake_event"]
        assert mine.shape == track["fake_event"].shape
        np.testing.assert_allclose(mine, track["fake_event"], rtol=0,
                                   atol=1e-5)
    assert got["gt_dict"] == ref["gt_dict"]

    keep = list(got["pred_buffer"])[::5]
    port_out = {**got, "pred_buffer": {th: got["pred_buffer"][th]
                                       for th in keep}}
    import matplotlib.pyplot as plt     # the numbers, not the figures
    monkeypatch.setattr(plt, "savefig", lambda *a, **k: None)
    theirs = jrunner._report_metrics(_to_jax(port_out), eval_cfg,
                                     tmp_path / "jax_metrics")
    mine = runner._report_metrics(port_out, eval_cfg,
                                  tmp_path / "port_metrics")
    assert mine.keys() == theirs.keys()
    for key, value in theirs.items():
        assert abs(mine[key] - value) <= 1e-9, key
    assert all(0.0 <= v <= 1.0 for v in mine.values())
    assert (tmp_path / "port_metrics" / "result.txt").is_file()


def test_evaluate_tagging_matches_jax(tagging, mapping_files, tmp_path,
                                     monkeypatch):
    port_dir, jax_dir, _ = _experiments(tagging, mapping_files, tmp_path,
                                        "weak")
    monkeypatch.setattr(jrcm.ClassMappingWeakRunner, "restore_state",
                        lambda self, *a, **k: _jax_state(tagging[1]))
    eval_cfg = {"resume": "best", "output": "tagging.tsv"}
    got = ClassMappingWeakRunner(device="cpu").evaluate_tagging(port_dir,
                                                                eval_cfg)
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(eval_cfg))
    ref = jrcm.ClassMappingWeakRunner().evaluate_tagging(jax_dir, str(path))
    np.testing.assert_array_equal(got["label_index"], ref["label_index"])
    np.testing.assert_allclose(got["ap"], ref["ap"], rtol=0, atol=1e-12)
    mine = pd.read_csv(port_dir / "tagging.tsv", sep="\t")
    theirs = pd.read_csv(jax_dir / "tagging.tsv", sep="\t")
    assert list(mine.columns) == list(theirs.columns)
    np.testing.assert_allclose(mine["ap"], theirs["ap"], rtol=0, atol=1e-12)


def test_average_precision_matches_sklearn():
    rng = np.random.default_rng(13)
    labels = (rng.uniform(size=(40, 6)) < 0.3).astype(np.float32)
    labels[:, 4] = 0                              # no positive: 0
    labels[:, 5] = 1                              # every row positive
    probs = np.round(rng.uniform(size=(40, 6)), 1).astype(np.float32)
    probs[:8, 0] = 0.5                            # ties across labels
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = pd.DataFrame({"ap": average_precision_score(
            labels, probs, average=None)}).fillna(0)["ap"].to_numpy()
    got = average_precision(labels, probs)
    assert got.dtype == np.float64 and got[4] == 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ------------------------------------------------------ shipped configs
@pytest.mark.parametrize("kind", ["weak", "strong", "eval"])
def test_shipped_config_builds_through_instantiate(kind, mapping_files):
    """``configs/class_mapping/*.yaml``: the model, and each split's
    dataset (its files swapped for ``mapping_files``) and collate, built
    by the port's registry; the collated batch has the configs' keys."""
    config = load_config(REPO / chip_smoke.CLASS_MAPPING_YAMLS[kind])
    if "model" in config:
        model = instantiate(config["model"], device="cpu")
        assert isinstance(model, AudioTagging)
        assert model.fc_output.out_features == 32
        assert instantiate(config["loss"]).__class__.__name__ == (
            "ClipBceLoss" if kind == "weak" else "MaskedFrameBceLoss")
    for split, cfg in config["data"].items():
        args = {**cfg["dataset"]["args"], "waveform": mapping_files["wav"],
                "label": mapping_files["label"],
                **_files(mapping_files, "phrase_embed", "cluster_model")}
        dataset = instantiate({"type": cfg["dataset"]["type"],
                               "args": args})
        batch = instantiate(cfg["collate_fn"])([dataset[i] for i in
                                                range(3)])
        assert batch["waveform"].shape == (3, 32000)
        assert batch["waveform_len"].tolist() == [32000] * 3
        if kind == "strong":
            assert batch["strong_label"].shape == (3, 100, 3)
        elif kind == "weak":
            assert batch["label"].shape == (3, 3)
        else:
            assert batch["text_idx"].dtype.kind == "i"


def _paths(node, cuts, prefix=""):
    """Every leaf of a nested dict as ``dotted.path -> value``; a path in
    ``cuts`` is a leaf."""
    if not isinstance(node, dict) or prefix[:-1] in cuts:
        return {prefix[:-1]: node}
    out = {}
    for key, value in node.items():
        out.update(_paths(value, cuts, f"{prefix}{key}."))
    return out


@pytest.mark.parametrize("kind", ["weak", "strong", "eval"])
def test_chip_smoke_class_mapping_config_is_the_yaml(kind):
    """``chip_smoke.py``'s class-mapping configs are the YAML files but
    for the keys ``CLASS_MAPPING_CUTS`` lists."""
    cuts = chip_smoke.CLASS_MAPPING_CUTS[kind]
    with open(REPO / chip_smoke.CLASS_MAPPING_YAMLS[kind]) as f:
        want = _paths(yaml.safe_load(f), cuts)
    got = _paths(chip_smoke._class_mapping_config(kind, "exp", "d.tsv"),
                 cuts)
    differ = {k for k in set(want) | set(got)
              if k not in want or k not in got or got[k] != want[k]}
    assert differ == set(cuts)
    if kind != "eval":
        assert got["trainer.epochs"] == chip_smoke.CM_EPOCHS[kind]
        assert got["trainer.epoch_length"] == chip_smoke.CM_STEPS
