"""The trainer's last switches: rematerialization, per-iteration learning
rates and ``debug_nans``.

The narrow model is ``tests/torch_ranks.py``'s (``BiEncoder`` over the
full-width ``Cnn8Rnn`` on 0.2 s clips, text width 64, weights made with
numpy from a seed), trained by ``StrongRunner.train_step`` or ``fit`` on
seeded numpy batches, on the CPU through the kernels' plain versions.
Tolerances:

* ``trainer.remat`` (the whole forward) and ``Cnn8Rnn(remat_blocks=)``
  (each block alone and all four) against the same steps without: two
  steps' losses, the first step's gradients, the running statistics after
  and the dropout generator's state after, bit for bit, on the f32 strong
  path and on bf16 route (b) (``bn_pool`` on every block, the bf16 GRU);
  the recompute is seen to run (the blocks' forwards counted);
* the port's remat steps against the JAX package's: the JAX runner's
  step with ``trainer.remat`` (its forward under ``jax.checkpoint``) and
  with ``TTG_TRAIN_REMAT=1234``, jitted, on the same weights (the JAX
  init, carried over by ``from_jax_variables``) and batch, dropout the
  identity on both sides, against the port's ``trainer.remat`` and
  ``remat_blocks=(1, 2, 3, 4)`` steps, to the limits of
  ``tests/test_torch_port_train.py``: loss rtol 1e-5, gradients by
  relative RMS 1e-4 after the conv trunk and 2e-2 in it, running
  statistics 1e-5 absolute;
* ``CosineWithWarmup`` at ``lr_update_interval: iteration``: every step's
  rate equals JAX's ``CosineWithWarmup(i)`` exactly, ``i`` counting from
  0, and the epoch log prints JAX's rate; at ``epoch`` interval a
  scheduler without ``step`` leaves the optimizer's rate, as JAX's
  ``hasattr`` guard does;
* ``trainer.debug_nans``: a NaN planted in a weight, or in a gradient
  (by a hook) of a forward that stays finite, raises
  ``FloatingPointError`` naming step 0 and the tensor, and anomaly mode
  is off after.
"""

import re

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from tests import torch_ranks as ranks
from texttoaudiogrounding_tpu.losses import FrameBceLoss as JFrameBce
from texttoaudiogrounding_tpu.models import BiEncoder as JBiEncoder
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.match import DotProduct as JDotProduct
from texttoaudiogrounding_tpu.training.optim import (
    CosineWithWarmup as JCosineWithWarmup,
)
from texttoaudiogrounding_tpu.training.runner_strong import (
    strong_output_transform as j_output_transform,
)
from texttoaudiogrounding_tpu_torch import (
    from_jax_variables,
    random_state_dict,
)
from texttoaudiogrounding_tpu_torch.losses import FrameBceLoss
from texttoaudiogrounding_tpu_torch.models import (
    BiEncoder,
    Cnn8Rnn,
    DotProduct,
    EmbeddingAgg,
    layers,
)
from texttoaudiogrounding_tpu_torch.parallel.mesh import device_feed
from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    StrongRunner,
    strong_output_transform,
)

ROUTES = {"f32": {},
          "bf16_b": {"dtype": torch.bfloat16, "gru_bwd": "bf16",
                     "bn_pool": (64, 128, 256, 512)}}
BLOCK_SETS = [(1,), (2,), (3,), (4,), (1, 2, 3, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these steps are small, and several threads a
    process under xdist spend their time waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(route: str, remat_blocks=()) -> BiEncoder:
    enc = Cnn8Rnn(remat_blocks=remat_blocks, **ROUTES[route])
    m = BiEncoder(enc, EmbeddingAgg(ranks.VOCAB, ranks.EMBED), DotProduct(),
                  shared_dim=ranks.EMBED, add_proj=True, device="cpu")
    m.load_state_dict(random_state_dict(m, 0))
    return m


def _run(route: str, remat: bool = False, remat_blocks=(),
         monkeypatch=None) -> dict:
    """Two train steps: losses, first gradients, running statistics and
    the encoder's generator state after, and the blocks' forward calls."""
    torch.manual_seed(1)
    m = _model(route, remat_blocks)
    runner = StrongRunner(device="cpu")
    runner.config = {"trainer": {"remat": remat}}
    opt = Optimizer({"type": "Adam", "args": {"lr": 1e-3}}, m.parameters(),
                    1.0)
    first: dict = {}

    def hook(loss, grads):
        if not first:
            first.update({n: p.grad.clone() for n, p in m.named_parameters()
                          if p.grad is not None})

    runner.post_grad_hook = hook
    calls = [0]
    forward = layers.ConvBlock.forward

    def counted(self, *a, **k):
        calls[0] += 1
        return forward(self, *a, **k)

    monkeypatch.setattr(layers.ConvBlock, "forward", counted)
    losses = [float(runner.train_step(m, FrameBceLoss(), opt, batch,
                                      strong_output_transform))
              for batch, _, _ in device_feed(ranks.batches(2, seed=3),
                                             ranks._mesh(None), "cpu")]
    monkeypatch.setattr(layers.ConvBlock, "forward", forward)
    return {"losses": losses, "grads": first,
            "stats": {n: b.clone() for n, b in m.named_buffers()
                      if "running" in n},
            "generator": m.audio_encoder._generator.get_state(),
            "block_calls": calls[0]}


@pytest.fixture(scope="module")
def plain_runs():
    mp = pytest.MonkeyPatch()
    try:
        yield {route: _run(route, monkeypatch=mp) for route in ROUTES}
    finally:
        mp.undo()


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("blocks", [None] + BLOCK_SETS,
                         ids=["whole"] + ["".join(map(str, b))
                                          for b in BLOCK_SETS])
def test_remat_step_equals_the_plain_step(plain_runs, route, blocks,
                                          monkeypatch):
    ref = plain_runs[route]
    got = (_run(route, remat=True, monkeypatch=monkeypatch) if blocks is None
           else _run(route, remat_blocks=blocks, monkeypatch=monkeypatch))
    # two steps of four blocks, and the recomputed ones once more
    assert ref["block_calls"] == 8
    assert got["block_calls"] == 8 + 2 * (4 if blocks is None
                                          else len(blocks))
    assert got["losses"] == ref["losses"]
    assert set(got["grads"]) == set(ref["grads"])
    for name, g in ref["grads"].items():
        assert torch.equal(got["grads"][name], g), name
    for name, s in ref["stats"].items():
        assert torch.equal(got["stats"][name], s), name
    assert torch.equal(got["generator"], ref["generator"])


def _rel_rms(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(torch.sqrt(((got - ref) ** 2).mean()
                            / (ref ** 2).mean().clamp_min(1e-30)))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model, its init and one batch of two 0.2 s clips."""
    batch = ranks.batches(1, b=2, seed=7)[0]
    jmodel = JBiEncoder(
        audio_encoder=JCnn8Rnn(sample_rate=32000),
        text_encoder=JEmbeddingAgg(vocab_size=ranks.VOCAB,
                                   embed_dim=ranks.EMBED),
        match_fn=JDotProduct(), shared_dim=ranks.EMBED, add_proj=True)
    # jitted: the eager init dispatches every op alone and takes 4x longer
    variables = jax.tree.map(np.asarray, jax.jit(lambda key: jmodel.init(
        {"params": key}, batch, train=False))(jax.random.PRNGKey(0)))
    return jmodel, variables, batch


def _jax_remat_step(jmodel, variables, batch, whole: bool) -> tuple:
    """The JAX runner's train step (``runner_base.py:184-210``): value and
    gradient of the frame BCE through ``strong_output_transform``, the
    batch statistics mutated, the forward under ``jax.checkpoint`` where
    ``whole``, jitted; (loss, gradients and statistics as the port's
    state dict)."""
    def loss_of(params):
        def apply_model(v, b):
            return jmodel.apply(v, b, train=True, mutable=["batch_stats"])
        if whole:
            apply_model = jax.checkpoint(apply_model)
        out, mut = apply_model({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               batch)
        return JFrameBce()(j_output_transform(out, batch)), mut

    (loss, mut), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])
    ref = from_jax_variables(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": mut["batch_stats"]}),
        _jax_twin())
    return float(loss), ref


def _jax_twin(remat_blocks=()) -> BiEncoder:
    return BiEncoder(Cnn8Rnn(dropout=(0.0, 0.0), remat_blocks=remat_blocks),
                     EmbeddingAgg(ranks.VOCAB, ranks.EMBED), DotProduct(),
                     shared_dim=ranks.EMBED, add_proj=True, device="cpu")


@pytest.mark.parametrize("switch", ["trainer_remat", "ttg_train_remat_1234"])
def test_remat_step_matches_the_jax_step(jax_init, switch, monkeypatch):
    jmodel, variables, batch = jax_init
    whole = switch == "trainer_remat"
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    if not whole:
        monkeypatch.setenv("TTG_TRAIN_REMAT", "1234")
    jloss, ref = _jax_remat_step(jmodel, variables, batch, whole)
    monkeypatch.undo()

    m = _jax_twin(() if whole else (1, 2, 3, 4))
    m.load_state_dict(from_jax_variables(variables, m))
    runner = StrongRunner(device="cpu")
    runner.config = {"trainer": {"remat": whole}}
    opt = Optimizer({"type": "Adam", "args": {"lr": 1e-3}}, m.parameters(),
                    1.0)
    grads: dict = {}
    runner.post_grad_hook = lambda loss, g: grads.update(
        {n: p.grad.clone() for n, p in m.named_parameters()
         if p.grad is not None})
    (tb, _, _), = device_feed([batch], ranks._mesh(None), "cpu")
    loss = float(runner.train_step(m, FrameBceLoss(), opt, tb,
                                   strong_output_transform))
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert set(grads) == {n for n, _ in m.named_parameters()}
    for name, g in grads.items():
        trunk = "conv_block" in name or "bn0" in name
        rel = _rel_rms(g, ref[name])
        assert rel <= (2e-2 if trunk else 1e-4), (name, rel)
    for name, buf in m.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_remat_blocks_are_conv_block_ids():
    with pytest.raises(ValueError):
        Cnn8Rnn(remat_blocks=(0,))
    with pytest.raises(ValueError):
        Cnn8Rnn(remat_blocks=(5,))


def _fit(tmp_path, trainer: dict, scheduler: dict | None = None,
         plant_nan: str | None = None) -> tuple:
    """``StrongRunner.fit`` over seeded in-memory batches (two train
    batches and one validation batch an epoch); returns (record, the log's
    text)."""
    runner = StrongRunner(device="cpu")
    config = {"experiment_path": str(tmp_path), "seed": 1,
              "optimizer": {"type": "Adam", "args": {"lr": 5e-4}},
              "trainer": {"epochs": 3, **trainer}}
    if scheduler is not None:
        config["lr_scheduler"] = scheduler
    runner.setup(config)
    exp_dir = runner.prepare_experiment()
    m = ranks.model()
    fc1 = m.audio_encoder.fc1.weight
    if plant_nan == "weight":
        with torch.no_grad():
            fc1[0, 0] = float("nan")
    elif plant_nan == "gradient":           # the forward stays finite
        fc1.register_hook(lambda g: g * float("nan"))
    record = runner.fit(m, FrameBceLoss(), ranks.batches(2, seed=5),
                        ranks.batches(1, seed=6), strong_output_transform,
                        exp_dir)
    return record, (exp_dir / "train.log").read_text()


COSINE = {"type": "CosineWithWarmup",
          "args": {"base_lr": 1e-3, "warmup_iters": 2, "total_iters": 5,
                   "final_lr_ratio": 0.1}}


def test_cosine_warmup_sets_every_steps_rate(tmp_path):
    record, log = _fit(tmp_path, {"lr_update_interval": "iteration"}, COSINE)
    jax_rule = JCosineWithWarmup(**COSINE["args"])
    assert record["step_lr"] == [jax_rule(i) for i in range(6)]
    assert np.isfinite(record["step_loss"]).all()
    # the epoch lines print the rate of the epoch's last step (JAX keeps
    # it in f32)
    printed = re.findall(r"lr: (\S+)", log)
    assert printed == [f"{float(np.float32(jax_rule(i))):.2g}"
                       for i in (1, 3, 5)]


def test_scheduler_without_step_leaves_the_rate(tmp_path):
    record, _ = _fit(tmp_path, {"lr_update_interval": "epoch"}, COSINE)
    assert record["step_lr"] == [5e-4] * 6


@pytest.mark.parametrize("plant,names", [
    ("weight", "loss"), ("gradient", "audio_encoder.fc1.weight")])
def test_debug_nans_raises_at_a_planted_nan(tmp_path, plant, names):
    assert not torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match=f"step 0: .*'{names}'"):
        _fit(tmp_path, {"debug_nans": True}, plant_nan=plant)
    assert not torch.is_anomaly_enabled()
