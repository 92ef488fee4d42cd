"""The port's mesh, batch sharding and multi-rank steps against the JAX
package and against one rank.

Ranks are gloo processes on the CPU (``tests/torch_ranks.py``: one
launcher imports the port once and forks each world's ranks; it imports
neither JAX nor the JAX package, which each rank reports).  The narrow
model is JAX ``tests/test_multichip.py``'s: ``Cnn8Rnn`` on 0.2 s clips,
embedding 64, weights made with numpy from a seed.  Tolerances:

* ``mesh_shape``, the rule placements (against JAX ``tree_shardings``
  through ``weights.flax_leaf``), ``pad_batch_to_multiple`` /
  ``shard_batch`` (against JAX's shards) and the predictor's
  ``_chunk_plan``: exact;
* dp2 against one rank, a ``StrongRunner`` step and a WSTAG
  ``MultiTextBiEncoder`` / ``ClipBceLoss`` step with dropout on: the
  losses of 4 steps within 2e-4 relative (JAX's own dp8 test), the first
  step's gradients within 1e-5 relative RMS a parameter, the running
  statistics after it within 1e-5 relative (bit for bit across the ranks).
  Both sides run torch on two threads and sum the BatchNorms' statistics
  in float64 (``layers.STATS_DTYPE``).  On this narrow model the first
  step's worst gradient gap is then 2.2e-6 at any thread count alike on
  both sides, against 9.0e-6 / 9.2e-6 with f32 sums at two or four threads
  and 1.7e-4 / 9.9e-4 at one; one thread against two moves it to up to
  1e-3 either way (torch's CPU kernels sum in another order on one
  thread; readings by ``python -m tests.torch_rank_gaps``);
* row 12's plain path (``bn_relu_dual_pool``) on dp2 against one rank on
  the whole batch: out, dx, dγ, dβ and the statistics within 1e-5;
* ``clip_by_global_norm_`` under tp2 against the unsharded norm: 1e-6
  relative;
* the dp2 x tp2 step (the shipped rules) against JAX's jitted step on a
  dp2 x tp2 mesh of four of the eight CPU devices, dropout the identity on
  both sides: loss 1e-5 relative, gradients 1e-4 relative RMS after the
  conv trunk and 2e-2 in it (``tests/test_torch_port_train.py``'s
  limits), running statistics 1e-5 absolute or 1e-6 relative.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from tests import torch_ranks as ranks
from texttoaudiogrounding_tpu.inference import (
    GroundingPredictor as JPredictor,
)
from texttoaudiogrounding_tpu.losses import FrameBceLoss as JFrameBce
from texttoaudiogrounding_tpu.models import BiEncoder as JBiEncoder
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.match import DotProduct as JDotProduct
from texttoaudiogrounding_tpu.parallel import mesh as jmesh
from texttoaudiogrounding_tpu.training.runner_strong import (
    strong_output_transform as j_output_transform,
)
from texttoaudiogrounding_tpu.training.torch_import import import_biencoder
from texttoaudiogrounding_tpu_torch import random_state_dict
from texttoaudiogrounding_tpu_torch.device import resolve_device
from texttoaudiogrounding_tpu_torch.inference import GroundingPredictor
from texttoaudiogrounding_tpu_torch.parallel.mesh import (
    mesh_shape,
    pad_batch_to_multiple,
    param_placements,
    shard_batch,
)
from texttoaudiogrounding_tpu_torch.weights import flax_leaf

TP = {"data": 2, "model": 2}
JOBS = [
    {"name": "dp2", "fn": "steps", "world": 2,
     "args": {"mesh_shape": {"data": 2}, "f64_stats": True}},
    {"name": "dp2_weak", "fn": "steps", "world": 2,
     "args": {"mesh_shape": {"data": 2}, "weak": True, "f64_stats": True}},
    {"name": "bn_pool", "fn": "bn_pool", "world": 2,
     "args": {"mesh_shape": {"data": 2}}},
    {"name": "clip", "fn": "clip", "world": 2,
     "args": {"mesh_shape": {"data": 1, "model": 2}}},
    {"name": "dp2tp2", "fn": "steps", "world": 4,
     "args": {"mesh_shape": TP, "rules": ranks.RULES, "n_steps": 1,
              "dropout": [0.0, 0.0]}},
]
WORLD = {job["name"]: job["world"] for job in JOBS}


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """Every world of this module, started once with the module's first
    test, in the background while the references compute here."""
    out = tmp_path_factory.mktemp("ranks")
    proc = ranks.start(out, JOBS)
    with ranks.sharing_the_cpu():
        yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _ranks(launched, name: str) -> list:
    return ranks.results(*launched, name, WORLD[name])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-30))


# ---------------------------------------------------------- pure Python
@pytest.mark.parametrize("cfg", [
    None, {"mesh": {"data": 8}}, {"mesh": {"data": -1, "model": 2}},
    {"mesh": {"data": 4, "model": 2}}, {"mesh": {"model": 2, "data": -1}}])
def test_mesh_shape_matches_jax(cfg):
    want = dict(jmesh.mesh_from_config(cfg).shape)
    got = mesh_shape(cfg, len(jax.devices()))
    assert got == want and list(got) == list(want)


def test_mesh_needing_more_ranks_raises_jax_text():
    cfg = {"mesh": {"data": 4, "model": 4}}
    with pytest.raises(ValueError) as jerr:
        jmesh.mesh_from_config(cfg)
    with pytest.raises(ValueError) as err:
        mesh_shape(cfg, 8)
    assert str(err.value) == str(jerr.value)


def test_mesh_smaller_than_the_world_raises():
    """JAX leaves devices idle; the port has no idle ranks."""
    with pytest.raises(ValueError, match="needs 4 devices, have 8"):
        mesh_shape({"mesh": {"data": 2, "model": 2}}, 8)


def _jax_spec(tree, path):
    for key in path:
        tree = tree[key]
    return tuple(tree.spec)


@pytest.mark.parametrize("vocab,rules", [
    (100, ranks.RULES),
    # the table does not divide: the first rule falls through to the next
    (101, [{"match": ["embedding"], "spec": ["model", None]},
           {"match": ["embedding"], "spec": [None, "model"]},
           {"match": ["fc1", "bias"], "spec": [None, "model"]}]),
    (100, [{"match": ["conv_block4", "conv2", "kernel"],
            "spec": [None, None, None, "model"]},
           {"match": ["fc1"], "spec": ["model"]},
           {"match": ["bn0", "scale"], "spec": ["data"]},
           {"match": ["text_proj", "kernel"], "spec": ["data", "model"]}]),
])
def test_placements_match_jax_tree_shardings(vocab, rules):
    from texttoaudiogrounding_tpu_torch.models import (
        BiEncoder,
        Cnn8Rnn,
        DotProduct,
        EmbeddingAgg,
    )
    model = BiEncoder(Cnn8Rnn(), EmbeddingAgg(vocab, ranks.EMBED),
                      DotProduct(), shared_dim=ranks.EMBED, add_proj=True,
                      device="cpu")
    params = import_biencoder({k: v.numpy() for k, v in random_state_dict(
        model, 0).items()})["params"]
    mesh = jmesh.get_mesh(jax.devices()[:4], ("data", "model"), (2, 2))
    jshard = jmesh.tree_shardings(params, mesh, rules)
    got = param_placements(model, dict(mesh.shape), rules)
    want = {}
    for name, p in model.named_parameters():
        paths, perm = flax_leaf(model, name)
        specs = [_jax_spec(jshard, path) for path in paths]
        if perm is None:
            assert all(not any(s) for s in specs), name
            continue
        spec = specs[0] + (None,) * (p.dim() - len(specs[0]))
        if any(ax is not None for ax in spec):
            want[name] = tuple(spec[perm[d]] for d in range(p.dim()))
    assert got == want
    assert got                       # every case shards something


@pytest.mark.parametrize("b,multiple", [(5, 4), (8, 4), (3, 8), (1, 2)])
def test_pad_batch_to_multiple_is_jax_bit_for_bit(b, multiple):
    rng = np.random.default_rng(b)
    batch = {"waveform": rng.normal(size=(b, 7)).astype(np.float32),
             "text": rng.integers(0, 9, (b, 3)), "ids": [f"a{i}"
                                                      for i in range(b)],
             "flat": rng.normal(size=(b + 1, 2))}
    got, real = pad_batch_to_multiple(batch, multiple)
    want, jreal = jmesh.pad_batch_to_multiple(batch, multiple)
    assert real == jreal == b and set(got) == set(want)
    for key in batch:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]


class _Mesh:
    """The part of ``parallel.mesh.Mesh`` that ``shard_batch`` reads."""

    def __init__(self, size: int, index: int):
        self.size, self.index = size, index

    def axis_size(self, name):
        return self.size if name == "data" else 1

    def coordinate(self, name):
        return self.index if name == "data" else 0


def test_shard_batch_matches_jax_shards():
    rng = np.random.default_rng(0)
    batch = {"waveform": rng.normal(size=(8, 5)).astype(np.float32),
             "text": rng.integers(0, 9, (8, 2, 3)),
             "flat": rng.normal(size=(6, 2)).astype(np.float32),
             "ids": list("abcdefgh")}
    mesh = jmesh.get_mesh(jax.devices()[:4])
    sharded = jmesh.shard_batch(batch, mesh)
    for rank, device in enumerate(mesh.devices.flat):
        got = shard_batch(batch, _Mesh(4, rank))
        for key in ("waveform", "text", "flat"):
            shard = [s for s in sharded[key].addressable_shards
                     if s.device == device][0]
            np.testing.assert_array_equal(got[key], np.asarray(shard.data))
        assert got["ids"] is batch["ids"]


@pytest.mark.parametrize("buckets", [(1, 8, 16, 32, 64, 128), (4, 6), ()])
@pytest.mark.parametrize("multiple", [1, 2, 3, 8])
def test_chunk_plan_matches_jax(buckets, multiple):
    state = SimpleNamespace(batch_buckets=tuple(sorted(buckets)),
                            _batch_multiple=multiple)
    for b in (1, 2, 3, 7, 8, 9, 31, 33, 130, 300):
        assert GroundingPredictor._chunk_plan(state, b) == \
            JPredictor._chunk_plan(state, b), b


def test_cuda_resolves_to_the_local_rank(monkeypatch):
    """Under a launcher a bare ``"cuda"`` is the rank's own card, made
    the current one; an explicit index stays."""
    chosen = []
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert chosen == [torch.device("cuda", 3)]
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert len(chosen) == 1


def test_fc1_runs_through_its_module():
    """A layer that replaces or hooks ``fc1`` sees its call."""
    model = ranks.model(dropout=(0.0, 0.0))
    seen = []
    model.audio_encoder.fc1.register_forward_hook(
        lambda mod, inp, out: seen.append(out.shape))
    model.text_encoder.embedding.core.register_forward_hook(
        lambda mod, inp, out: seen.append(out.shape))
    batch = ranks.batches(1)[0]
    model.eval()
    with torch.no_grad():
        model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert seen == [(4, 5, 512), (4, 4, ranks.EMBED)]


@pytest.mark.parametrize("runner", [
    "runner_strong.StrongRunner",
    "runner_weak_phrase.WeakPhraseRunner",
    "runner_weak_phrase.WeakPhraseSelfSupervisionRunner",
    "runner_weak_sentence.WeakSentenceRunner",
    "runner_class_mapping.ClassMappingStrongRunner",
    "runner_class_mapping.ClassMappingWeakRunner"])
def test_runners_set_up_on_a_dp2_mesh(monkeypatch, runner):
    """Every runner's step is held on several ranks, so each sets up on a
    ``data`` mesh of two (the steps themselves:
    ``tests/test_torch_port_parallel_runners.py``)."""
    import importlib

    from texttoaudiogrounding_tpu_torch.parallel.mesh import Mesh
    from texttoaudiogrounding_tpu_torch.training import runner_base

    module, cls = runner.split(".")
    runner_cls = getattr(importlib.import_module(
        f"texttoaudiogrounding_tpu_torch.training.{module}"), cls)
    monkeypatch.setattr(runner_base, "mesh_from_config",
                        lambda cfg, device: Mesh({"data": 2}))
    made = runner_cls(device="cpu")
    assert made.setup({}).get("seed") == 1
    assert made.mesh.shape == {"data": 2}


# ------------------------------------------------------------- the ranks
@pytest.fixture(scope="module")
def jax_dp2tp2_step():
    """JAX's jitted strong step on a dp2 x tp2 mesh with the shipped rules,
    from the port's seeded weights carried across."""
    port = ranks.model(dropout=(0.0, 0.0))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = import_biencoder(sd)
    model = JBiEncoder(
        audio_encoder=JCnn8Rnn(sample_rate=32000),
        text_encoder=JEmbeddingAgg(vocab_size=ranks.VOCAB,
                                   embed_dim=ranks.EMBED),
        match_fn=JDotProduct(), shared_dim=ranks.EMBED, add_proj=True)
    batch = ranks.batches(1)[0]
    mesh = jmesh.get_mesh(jax.devices()[:4], ("data", "model"), (2, 2))
    rep = jmesh.replicate(mesh)

    def step(params, batch_stats, batch):
        def loss_of(p):
            out, mut = model.apply({"params": p, "batch_stats": batch_stats},
                                   batch, train=True,
                                   mutable=["batch_stats"])
            return JFrameBce()(j_output_transform(out, batch)), mut

        (loss, mut), grads = jax.value_and_grad(loss_of, has_aux=True)(
            params)
        return loss, grads, mut["batch_stats"]

    pshard = jmesh.tree_shardings(variables["params"], mesh, ranks.RULES)
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        loss, grads, stats = jax.jit(
            step, in_shardings=(pshard, rep, jmesh.batch_sharding(mesh)),
            out_shardings=(rep, pshard, rep))(
                jax.device_put(variables["params"], pshard),
                jax.device_put(variables["batch_stats"], rep),
                jmesh.shard_batch(batch, mesh))
    finally:
        mp.undo()
    from texttoaudiogrounding_tpu_torch import from_jax_variables
    ref = from_jax_variables(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": stats}), port)
    return float(loss), ref


@pytest.mark.timeout(300)
def test_dp2tp2_step_matches_jax(launched, jax_dp2tp2_step):
    jloss, ref = jax_dp2tp2_step
    got = _ranks(launched, "dp2tp2")
    for rank in got:
        assert rank["losses"][0] == pytest.approx(jloss, rel=1e-5)
        assert rank["local_shapes"]["audio_encoder.fc1.weight"] == (256, 512)
        assert rank["local_shapes"][
            "text_encoder.embedding.core.weight"] == (ranks.VOCAB // 2,
                                                      ranks.EMBED)
        for name, g in rank["grads"].items():
            trunk = "conv_block" in name or "bn0" in name
            assert _rel(g, ref[name]) <= (2e-2 if trunk else 1e-4), name
        for name, s in rank["first_stats"].items():
            np.testing.assert_allclose(s, ref[name], rtol=1e-6, atol=1e-5,
                                       err_msg=name)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("weak", [False, True], ids=["strong", "wstag"])
def test_dp2_step_matches_one_rank(launched, weak):
    ref = ranks.steps(None, weak=weak, f64_stats=True)
    got = _ranks(launched, "dp2_weak" if weak else "dp2")
    for rank in got:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=2e-4)
        for name, g in ref["grads"].items():
            assert _rel(rank["grads"][name], g) <= 1e-5, name
        for name, s in ref["first_stats"].items():
            np.testing.assert_allclose(rank["first_stats"][name], s,
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        assert rank["local_shapes"] == ref["local_shapes"]
    for name in ref["stats"]:
        assert torch.equal(got[0]["stats"][name], got[1]["stats"][name])


@pytest.mark.timeout(300)
def test_row12_plain_path_under_dp2_matches_one_rank(launched):
    ref = ranks.bn_pool(None)
    got = _ranks(launched, "bn_pool")
    for rank in got:
        lo, hi = rank["rows"]
        for key in ("out", "dx"):
            np.testing.assert_allclose(rank[key], ref[key][lo:hi],
                                       rtol=0, atol=1e-5, err_msg=key)
        for key in ("dgamma", "dbeta", "mean", "var"):
            np.testing.assert_allclose(rank[key], ref[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)


@pytest.mark.timeout(300)
def test_clip_under_tp2_counts_every_shard_once(launched):
    ref = ranks.clip(None)
    got = _ranks(launched, "clip")
    assert ref["sharded"] == []
    for rank in got:
        assert rank["sharded"] == ["audio_encoder.fc1.weight",
                                   "text_encoder.embedding.core.weight"]
        assert rank["norm"] == pytest.approx(ref["norm"], rel=1e-6)
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(rank["grads"][name], g, rtol=1e-6,
                                       atol=1e-9, err_msg=name)


@pytest.mark.timeout(300)
def test_ranks_import_no_jax(launched):
    for name in WORLD:
        for rank in _ranks(launched, name):
            assert rank["jax_modules"] == [], name
