"""The port's bf16 mixed-precision training against the JAX package.

``Cnn8Rnn(dtype=torch.bfloat16)`` is the JAX package's ``dtype:
bfloat16`` training mode, with the pool kernels opted in as ``TTG_BN_POOL``
/ ``TTG_POOL_VJP`` opt them in and the bf16 trainable GRU as
``TTG_GRU_BWD=bf16``; the JAX kernels run in interpret mode
(``TTG_PALLAS_INTERPRET=1``), the port's as their plain versions (CPU).
Same weights (the JAX init through ``from_jax_variables``), same numpy
inputs, dropout the identity on both sides.  Tolerances:

* one train-mode bf16 ``ConvBlock`` at each Cnn8Rnn block geometry, on the
  same bf16 input, plain and through either pool kernel: loss rtol 5e-5
  (measured at most 2.3e-5; summing the plain path's 2 x 2 windows in f32
  and rounding once, instead of after every add as XLA does, reads 6.8e-5
  at block 2), every gradient within 2e-2 relative RMS (measured at most
  8.3e-3: bf16 roundings of sums taken in another order), running
  statistics 1e-4
  (one conv output rounded to the other bf16 neighbour moves its
  channel's mean by about 1e-5 here; measured at most 1.5e-5);
* one whole train step in f32 with the kernel routes on: the whole-step
  tolerances of ``tests/test_torch_port_train.py`` (loss rtol 1e-5,
  gradients 1e-4 relative RMS after the conv trunk and 2e-2 in it,
  running statistics 1e-5);
* one whole train step in bf16: loss rtol 2e-3 (measured 2.8e-4), running
  statistics 2e-3 (measured 2.8e-4), gradients 6e-2 relative RMS after the
  trunk and 0.3 in it (measured 3.4e-2 and 0.20).  These two bounds are
  the step's own sensitivity, not the port's error: scaling the waveform
  by 1 + 1e-6 moves the JAX bf16 step's gradients by 0.27 in the trunk and
  0.040 after it (the port's by 0.24 and 0.049), because bf16 roundings
  flip max-pool and ReLU routings, which move gradient mass; in f32 the
  same perturbation moves the trunk by 1.9e-2.  The per-block test above
  is where the trunk is held tight, and the next one the layers after it;
* the same bf16 step run on from JAX's own values at two points, in both
  packages: block 4's output is replaced by JAX's trunk output (so that no
  routing flip reaches the layers after it), and the BiGRU's input takes
  the value it had in JAX's forward, with the gradient passed straight
  through (``x + stop_gradient(pin - x)``; a forward pre-hook in the
  port).  Without the second pin, fc1's f32 sums (XLA's against oneDNN's,
  whose kernel depends on the CPU) differ in the last bit in 45 % of the
  GRU's inputs, and the few of them that lie at a bf16 rounding midpoint
  (3 of 25600 on an 8-core Xeon with AMX) round to the other neighbour
  under ``bwd="bf16"``'s input-projection rounding: the loss then moved
  by 1.5e-5, the gradients after the trunk by up to 1.0e-3 and the trunk
  output's by 1.9e-3, while on another CPU they read 5.2e-4 and 9.0e-4.
  Pinned, the comparison measures the GRU's own bf16 algorithm: loss
  rtol 1e-6 (measured 7.0e-8, with 1 to 8 threads), every gradient after
  the trunk within 1e-3 relative RMS (measured at most 3.5e-4) and the
  gradient of the trunk output within 1.5e-3 (measured 5.2e-4), the gaps
  that carry and ``dcol`` roundings flipped by the last-bit differences
  of the GRU's own products leave.  Mutants of the port, on a copy: the
  train-mode GRU run in bf16 reads 2.4e-3 after the trunk and 3.4e-3 on
  the trunk output; the bf16 backward given f32 operands 1.7e-3 and
  2.9e-3; the input projection's operands left in f32 3.1e-3 and 4.2e-3,
  with the loss 3.7e-5 off;
* the eval-mode bf16 forward (log-mel kernel, ``pool_vjp`` blocks 3-4, the
  bf16 grouped GRU loop): ``frame_sim`` within 2e-3.

XLA's CPU runtime has no dot of bf16 operands into f32 (``DotThunk``),
which the JAX BiGRU's input projection asks for under
``TTG_GRU_BWD=bf16``; the JAX reference here gives such einsums the same
bf16 values as f32 operands: the same exact products, summed in f32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import make_grounding_data, make_vocab
from tests.test_torch_port_pool import BLOCKS, _port_block
from tests.test_torch_port_train import (
    _EMBED,
    _VOCAB,
    _collate_args,
    _rel_rms,
    _step_batch,
)
from texttoaudiogrounding_tpu.losses import FrameBceLoss as JFrameBce
from texttoaudiogrounding_tpu.models import BiEncoder as JBiEncoder
from texttoaudiogrounding_tpu.models import Cnn8Rnn as JCnn8Rnn
from texttoaudiogrounding_tpu.models import EmbeddingAgg as JEmbeddingAgg
from texttoaudiogrounding_tpu.models.layers import BiGRU as JBiGRU
from texttoaudiogrounding_tpu.models.layers import ConvBlock as JConvBlock
from texttoaudiogrounding_tpu.models.match import ExpNegL2 as JExpNegL2
from texttoaudiogrounding_tpu.training.runner_strong import (
    strong_output_transform as j_output_transform,
)
from texttoaudiogrounding_tpu_torch import from_jax_variables
from texttoaudiogrounding_tpu_torch.data.loader import to_device
from texttoaudiogrounding_tpu_torch.losses import FrameBceLoss
from texttoaudiogrounding_tpu_torch.models import (
    BiEncoder,
    Cnn8Rnn,
    EmbeddingAgg,
    ExpNegL2,
)
from texttoaudiogrounding_tpu_torch.training.runner_strong import (
    StrongRunner,
    strong_output_transform,
)
from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

_ROUTES = {"bn_pool": (64, 128), "pool_vjp": (256, 512)}
_JAX_ENV = {"TTG_PALLAS_INTERPRET": "1", "TTG_BN_POOL": "64,128",
            "TTG_POOL_VJP": "256,512"}


def _f32_operand_einsum(mp):
    einsum = jnp.einsum

    def patched(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(spec, *ops, preferred_element_type=preferred_element_type,
                      **kw)

    mp.setattr(jnp, "einsum", patched)


def _jax_model(dtype):
    return JBiEncoder(
        audio_encoder=JCnn8Rnn(sample_rate=32000, dtype=dtype),
        text_encoder=JEmbeddingAgg(vocab_size=_VOCAB, embed_dim=_EMBED),
        match_fn=JExpNegL2(), shared_dim=_EMBED, add_proj=True)


def _port_model(dtype, **opts):
    audio = Cnn8Rnn(dtype=dtype, **opts)
    return BiEncoder(audio, EmbeddingAgg(_VOCAB, _EMBED), ExpNegL2(),
                     shared_dim=_EMBED, add_proj=True, device="cpu")


def _block4(ctx) -> bool:
    return (isinstance(ctx.module, JConvBlock) and ctx.method_name ==
            "__call__" and ctx.module.name == "conv_block4")


def _gru(ctx) -> bool:
    return isinstance(ctx.module, JBiGRU) and ctx.method_name == "__call__"


def _jax_step(dtype, pin_trunk=False):
    """The JAX runner's train step with the kernel routes on, dropout the
    identity: (variables, batch, loss, the port-named gradients and mutated
    running statistics, the pins).  With ``pin_trunk`` the step runs on
    from the trunk output of a first forward, taken as an input (block 4's
    output replaced by it), whose gradient joins the others under
    ``"trunk"``; and the BiGRU's input takes the value it had in that
    forward, with the gradient passed straight through (``x +
    stop_gradient(pin - x)``).  The pins are ``{"trunk", "rnn"}``."""
    batch = _step_batch()
    jmodel = _jax_model(dtype)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0)}, batch, train=False))
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    for key, value in _JAX_ENV.items():
        mp.setenv(key, value)
    if dtype == jnp.bfloat16:
        mp.setenv("TTG_GRU_BWD", "bf16")
        _f32_operand_einsum(mp)
    pins = None
    try:
        if pin_trunk:
            pins = {}

            def take(f, args, kwargs, ctx):
                out = f(*args, **kwargs)
                if _block4(ctx):
                    pins["trunk"] = np.asarray(out)
                if _gru(ctx):
                    pins["rnn"] = np.asarray(args[0])
                return out

            with fnn.intercept_methods(take):
                jmodel.apply(variables, batch, train=True,
                             mutable=["batch_stats"])

        def loss_of(params, z):
            def pin(f, args, kwargs, ctx):
                if pin_trunk and _block4(ctx):
                    return z
                if pin_trunk and _gru(ctx):
                    x = args[0]
                    x = x + jax.lax.stop_gradient(pins["rnn"] - x)
                    return f(x, *args[1:], **kwargs)
                return f(*args, **kwargs)

            with fnn.intercept_methods(pin):
                out, mut = jmodel.apply(
                    {"params": params,
                     "batch_stats": variables["batch_stats"]},
                    batch, train=True, mutable=["batch_stats"])
            return JFrameBce()(j_output_transform(out, batch)), mut

        z = jnp.zeros(()) if pins is None else jnp.asarray(pins["trunk"])
        (loss, mut), (grads, dz) = jax.value_and_grad(
            loss_of, argnums=(0, 1), has_aux=True)(variables["params"], z)
    finally:
        mp.undo()
    ref = from_jax_variables(jax.tree.map(
        np.asarray, {"params": grads, "batch_stats": mut["batch_stats"]}),
        _port_model(torch.float32))
    ref["trunk"] = torch.from_numpy(np.array(dz, np.float32))
    return variables, batch, float(loss), ref, pins


def _port_step(variables, batch, dtype, pins=None, **opts):
    """The port's step; with ``pins`` (JAX's, see :func:`_jax_step`) block
    4's output is replaced by ``pins["trunk"]``, whose gradient is the
    model's ``trunk``, and the BiGRU's input takes the value
    ``pins["rnn"]`` with the gradient passed straight through."""
    model = _port_model(dtype, dropout=(0.0, 0.0), **_ROUTES, **opts)
    model.load_state_dict(from_jax_variables(variables, model))
    model.train()
    if pins is not None:
        model.trunk = torch.from_numpy(np.asarray(
            pins["trunk"], np.float32)).to(dtype).requires_grad_()
        model.audio_encoder.conv_block4.register_forward_hook(
            lambda mod, args, out: model.trunk)
        x_pin = torch.from_numpy(np.array(pins["rnn"], np.float32))
        model.audio_encoder.rnn.register_forward_pre_hook(
            lambda mod, args, kwargs: (
                (args[0] + (x_pin - args[0]).detach(),) + args[1:], kwargs),
            with_kwargs=True)
    tb = to_device(batch, torch.device("cpu"))
    loss = FrameBceLoss()(strong_output_transform(model(tb), tb))
    loss.backward()
    return model, loss.item()


def _check_step(model, loss, jloss, ref, loss_rtol, trunk_tol, rest_tol,
                stats_tol):
    assert loss == pytest.approx(jloss, rel=loss_rtol)
    for name, p in model.named_parameters():
        trunk = "conv_block" in name or "bn0" in name
        rel = _rel_rms(p.grad.numpy(), ref[name].numpy())
        assert rel <= (trunk_tol if trunk else rest_tol), (name, rel)
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                       rtol=0, atol=stats_tol, err_msg=name)


@pytest.mark.parametrize("route", ["plain", "bn_pool", "pool_vjp"])
@pytest.mark.parametrize("t,m,cin,cout,pool", BLOCKS)
def test_bf16_conv_block_matches_jax(t, m, cin, cout, pool, route,
                                     monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, t, m, cin)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jblock = JConvBlock(cout, dtype=jnp.bfloat16)
    var = jblock.init(jax.random.PRNGKey(1), xb, bn_train=False)
    monkeypatch.setenv("TTG_PALLAS_INTERPRET", "1")
    if route != "plain":
        monkeypatch.setenv("TTG_BN_POOL" if route == "bn_pool" else
                           "TTG_POOL_VJP", str(cout))

    def jloss(p):
        out, mut = jblock.apply({"params": p,
                                 "batch_stats": var["batch_stats"]},
                                xb, bn_train=True, pool_size=pool,
                                mutable=["batch_stats"])
        return (jnp.sum(out.astype(jnp.float32) ** 2) * 1e-3,
                (out, mut["batch_stats"]))

    (jl, (jout, jstats)), jg = jax.value_and_grad(jloss, has_aux=True)(
        var["params"])
    opts = {} if route == "plain" else {route: True}
    block = _port_block(cin, cout, var["params"], var["batch_stats"], **opts)
    out = block(torch.from_numpy(x).to(torch.bfloat16), pool)
    assert out.dtype == torch.bfloat16 and out.shape == jout.shape
    loss = (out.float() ** 2).sum() * 1e-3
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=5e-5)
    for name, mod, key in (("conv1", block.conv1, "kernel"),
                           ("conv2", block.conv2, "kernel"),
                           ("bn1", block.bn1, "scale"),
                           ("bn2", block.bn2, "scale"),
                           ("bn1", block.bn1, "bias"),
                           ("bn2", block.bn2, "bias")):
        ref = np.asarray(jg[name][key])
        got = (mod.bias if key == "bias" else mod.weight).grad.numpy()
        if key == "kernel":
            ref = ref.transpose(3, 2, 0, 1)
        assert _rel_rms(got, ref) <= 2e-2, (name, key, _rel_rms(got, ref))
    for bn in ("bn1", "bn2"):
        mod = getattr(block, bn)
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(jstats[bn]["mean"]), atol=1e-4)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(jstats[bn]["var"]), atol=1e-4)


def test_f32_train_step_with_kernel_routes_matches_the_jax_runner():
    variables, batch, jloss, ref, _ = _jax_step(jnp.float32)
    model, loss = _port_step(variables, batch, torch.float32)
    _check_step(model, loss, jloss, ref, 1e-5, 2e-2, 1e-4, 1e-5)


def test_bf16_train_step_matches_the_jax_runner():
    variables, batch, jloss, ref, _ = _jax_step(jnp.bfloat16)
    model, loss = _port_step(variables, batch, torch.bfloat16,
                             gru_bwd="bf16")
    _check_step(model, loss, jloss, ref, 2e-3, 0.3, 6e-2, 2e-3)


def test_bf16_train_step_after_the_trunk_matches_the_jax_runner():
    variables, batch, jloss, ref, pins = _jax_step(jnp.bfloat16, True)
    model, loss = _port_step(variables, batch, torch.bfloat16, pins,
                             gru_bwd="bf16")
    assert loss == pytest.approx(jloss, rel=1e-6)
    rest = {n: p.grad for n, p in model.named_parameters()
            if not ("conv_block" in n or "bn0" in n)}
    assert len(rest) == 15
    for name, got in rest.items():
        rel = _rel_rms(got.numpy(), ref[name].numpy())
        assert rel <= 1e-3, (name, rel)
    rel = _rel_rms(model.trunk.grad.float().numpy(), ref["trunk"].numpy())
    assert rel <= 1.5e-3, rel


def test_bf16_eval_forward_matches_jax(monkeypatch):
    batch = _step_batch()
    jmodel = _jax_model(jnp.bfloat16)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(2)}, batch, train=False))
    monkeypatch.setenv("TTG_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TTG_POOL_VJP", "256,512")
    ref = np.asarray(jmodel.apply(variables, batch, train=False)["frame_sim"])
    model = _port_model(torch.bfloat16, **_ROUTES, gru_bwd="bf16")
    model.load_state_dict(from_jax_variables(variables, model))
    rnn = model.audio_encoder.rnn
    assert rnn.route() == (torch.bfloat16, False, torch.bfloat16, None)
    assert rnn.route(torch.float32) == (torch.float32, True, torch.bfloat16,
                                        None)
    with torch.no_grad():
        got = model(to_device(batch, torch.device("cpu")))["frame_sim"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-3)


def test_bf16_model_takes_the_jax_variables_unchanged():
    jmodel = _jax_model(jnp.bfloat16)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0)}, _step_batch(), train=False))
    model = _port_model(torch.bfloat16, **_ROUTES, gru_bwd="bf16")
    sd = from_jax_variables(variables, model)
    model.load_state_dict(sd)                        # strict
    assert set(model.state_dict()) == set(_port_model(torch.float32)
                                          .state_dict()) == set(sd)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_cnn8rnn_dtype_and_conv_mode_combinations():
    batch = to_device(_step_batch(), torch.device("cpu"))
    allowed = [(torch.float32, None, (True, False)),
               (torch.bfloat16, None, (True, False)),
               (torch.bfloat16, "bf16", (False,)),
               (torch.bfloat16, "int8", (False,))]
    for dtype, conv_mode, modes in allowed:
        enc = Cnn8Rnn(dtype=dtype, conv_mode=conv_mode)
        for train in (True, False):
            enc.train(train)
            if train in modes:
                with torch.no_grad():
                    out = enc(batch)["embedding"]
                assert out.dtype == torch.float32
                assert torch.isfinite(out).all()
            else:
                with pytest.raises(ValueError, match="conv_mode=None"):
                    enc(batch)
    for conv_mode in ("bf16", "int8"):
        with pytest.raises(ValueError, match="dtype=bfloat16"):
            Cnn8Rnn(conv_mode=conv_mode)
    with pytest.raises(ValueError, match="dtype"):
        Cnn8Rnn(dtype=torch.float16)
    for dtype, bwd in ((torch.float32, "v2"), (torch.bfloat16, "v3")):
        rnn = Cnn8Rnn(dtype=dtype, gru_bwd=bwd).rnn      # the f32 train GRU
        assert rnn.route(torch.float32) == (torch.float32, True,
                                            torch.float32, bwd)
    # freeze_bn (ported): train mode keeps the running statistics
    enc = Cnn8Rnn(freeze_bn=True).train()
    before = enc.bn0.running_mean.clone()
    with torch.no_grad():
        enc(batch)
    assert torch.equal(enc.bn0.running_mean, before)


def test_registry_makes_the_bf16_model_from_the_config():
    cfg = {"type": "Cnn8Rnn",
           "args": {"dtype": "bfloat16", "gru_bwd": "bf16",
                    "bn_pool": [64, 128], "pool_vjp": [256, 512]}}
    enc = instantiate(cfg)
    assert enc.dtype == torch.bfloat16 and enc.rnn.bwd == "bf16"
    assert [(b.bn_pool, b.pool_vjp) for b in (
        enc.conv_block1, enc.conv_block2, enc.conv_block3,
        enc.conv_block4)] == [(True, False), (True, False), (False, True),
                              (False, True)]
    assert instantiate({"type": "Cnn8Rnn", "args": {"dtype": "float32"}}
                       ).dtype == torch.float32
    with pytest.raises(ValueError, match="dtype"):
        instantiate({"type": "Cnn8Rnn", "args": {"dtype": "float16"}})


def test_strong_runner_trains_the_bf16_config(tmp_path):
    # four clips: one step an epoch, so that four epochs stay short
    wav_csv, label_json, _ = make_grounding_data(
        tmp_path / "data", num_audio=4, duration=1.0, seed=3,
        event_len=(0.15, 0.3))
    vocab = make_vocab(label_json, tmp_path / "data" / "vocab.pkl")

    def loader():
        return {
            "dataset": {"type": "AudioPhraseDataset",
                        "args": {"waveform": str(wav_csv),
                                 "label": str(label_json),
                                 "time_resolution": 0.04}},
            "collate_fn": {"type": "TextCollate", "args": {
                **_collate_args(),
                "tokenizer": {"type": "DictTokenizer", "args": {
                    "vocabulary": str(tmp_path / "data" / "vocab.pkl")}}}},
            "dataloader_args": {"batch_size": 4},
        }

    config = {
        "experiment_path": str(tmp_path / "exp"), "seed": 1,
        "data": {"train": loader(), "val": loader()},
        "model": {
            "type": "BiEncoder",
            "args": {"shared_dim": _EMBED, "add_proj": True},
            "audio_encoder": {"type": "Cnn8Rnn", "args": {
                "sample_rate": 32000, "dtype": "bfloat16", "gru_bwd": "bf16",
                "bn_pool": [64, 128], "pool_vjp": [256, 512]}},
            "text_encoder": {"type": "EmbeddingAgg",
                             "args": {"vocab_size": len(vocab),
                                      "embed_dim": _EMBED}},
            "match_fn": {"type": "ExpNegL2", "args": {}},
        },
        "loss": {"type": "FrameBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 2e-3}},
        "trainer": {"epochs": 4, "save_interval": 1, "max_grad_norm": 1.0},
    }
    exp_dir = StrongRunner(device="cpu").train(config)
    log = (exp_dir / "train.log").read_text()
    assert "epoch: 4" in log and "bfloat16" in log
    losses = [float(line.split("train_loss: ")[1].split()[0])
              for line in log.splitlines() if "train_loss: " in line]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    sd = torch.load(exp_dir / "last.pth", weights_only=True)["model"]
    assert all(v.dtype != torch.bfloat16 for v in sd.values())
    f32 = BiEncoder(Cnn8Rnn(), EmbeddingAgg(len(vocab), _EMBED), ExpNegL2(),
                    shared_dim=_EMBED, add_proj=True, device="cpu")
    f32.load_state_dict(sd)                          # f32 weights, strict
