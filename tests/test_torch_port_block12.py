"""The port's blocks-1-2 serving designs against the JAX package.

``fused_pair_conv_pool`` (``ops/pallas/conv_block.py:691``), the
pair-dense ``fused_block2`` and ``fused_block1``
(``ops/pallas/conv_block_small.py:291``, ``:471``), block 1's all-int8
mode (``fused_block1_pair(quantize=True)``, ``TTG_B1_QUANT=1``) and its
single staging (``mode="single"``, ``TTG_B1_MODE``): the same
numpy-seeded inputs go through the JAX kernel in interpret mode and the
port's wrapper on the CPU, which runs its plain PyTorch version.  Small T
and small ``tc`` give several chunks, so the per-chunk int8 scales are
exercised.

Tolerances:
* ``compute_dtype=float32``: within 1e-4 (absolute and relative) of the
  JAX kernel and of an XLA block (``lax.conv``, ``xla_ref``);
* bf16: relative RMS ≤ 1e-2 against the JAX kernel;
* int8 at equal ``tc``: relative RMS ≤ 2e-3 against the JAX kernel — a
  third of what one design difference moves (rounding the pair block's
  conv1 rows to bf16 before their scale or not, another ``tc``: 5e-3 to
  8e-3 at these sizes) — and < 0.05 against the f32 XLA block;
* the model: ``Cnn8Rnn(bf16, conv_mode="int8", block1_quant="int8")``
  against the JAX model under ``TTG_FUSED_CONV=int8 TTG_B1_QUANT=1``,
  audio embedding within relative RMS 2e-2, as the default int8 path is
  held (``tests/test_torch_port_model.py``).
The kernels run only on a CUDA card; ``chip_smoke.py`` holds each against
its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_conv_block_small import xla_ref
from tests.test_torch_port_model import (  # noqa: F401 (a fixture)
    _EMBED,
    _VOCAB,
    _batch,
    _jax_model,
    _port_outputs,
    variables,
)
from tests.test_torch_port_kernels import (
    _bf16,
    _block_case,
    _jab,
    _rel_rms,
    _tab,
    _to_np,
)
from texttoaudiogrounding_tpu.ops.pallas import conv_block as jcb
from texttoaudiogrounding_tpu.ops.pallas import conv_block1_pair as jb1
from texttoaudiogrounding_tpu.ops.pallas import conv_block_small as jbs
from texttoaudiogrounding_tpu_torch import (
    BiEncoder,
    Cnn8Rnn,
    DotProduct,
    EmbeddingAgg,
    flagship_model,
    from_jax_variables,
)
from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock
from texttoaudiogrounding_tpu_torch.ops.kernels import block1_small as tb7
from texttoaudiogrounding_tpu_torch.ops.kernels import block2_small as tb6
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair as tb1
from texttoaudiogrounding_tpu_torch.ops.kernels import pair_conv_pool as tpc

INT8_TOL, BF16_TOL, F32_TOL = 2e-3, 1e-2, 1e-4
MODES = {"f32": (False, jnp.float32, torch.float32),
         "bf16": (False, jnp.bfloat16, torch.bfloat16),
         "int8": (True, jnp.bfloat16, torch.bfloat16)}


def _inputs(x, mode):
    """x as the JAX and the port's function take it in ``mode``."""
    if mode == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    return _bf16(x)


def _check(mode, got, ref, f32_ref=None):
    got, ref = _to_np(got), _to_np(ref)
    assert got.shape == ref.shape
    if mode == "f32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
        if f32_ref is not None:
            np.testing.assert_allclose(got, np.asarray(f32_ref),
                                       rtol=F32_TOL, atol=F32_TOL)
    else:
        assert _rel_rms(got, ref) <= (INT8_TOL if mode == "int8"
                                      else BF16_TOL)
        if mode == "int8" and f32_ref is not None:
            assert _rel_rms(got, f32_ref) < 0.05


# ---------------------------------------- row 5: fused_pair_conv_pool

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("t,m,cout,pt,tc", [(8, 16, 64, 2, 4),
                                            (12, 8, 128, 1, 4)])
def test_pair_conv_pool_matches_pallas(mode, t, m, cout, pt, tc):
    quantize, jdt, tdt = MODES[mode]
    x, w1, ab1, w2, ab2 = _block_case(t, m, 64, cout, seed=t + pt)
    jx, tx = _inputs(x, mode)
    ref = jcb.fused_pair_conv_pool(
        jx, jnp.asarray(w1), _jab(ab1), jnp.asarray(w2), _jab(ab2), (pt, 2),
        quantize=quantize, tc=tc, compute_dtype=jdt, interpret=True)
    got = tpc.fused_pair_conv_pool(
        tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2), _tab(ab2),
        (pt, 2), quantize=quantize, tc=tc, compute_dtype=tdt)
    assert got.dtype == (torch.bfloat16 if quantize else tdt)
    assert got.shape == (2, t // pt, m // 2, cout)
    # the function has no JAX test: also an independent XLA block
    f32 = xla_ref(jnp.asarray(jx, jnp.float32), jnp.asarray(w1), _jab(ab1),
                  jnp.asarray(w2), _jab(ab2), pool=(pt, 2))
    _check(mode, got, ref, f32)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("pt", [2, 1])
def test_pair_conv_pool_conv2_only_matches_pallas(quantize, pt):
    """``w1=None``: x is the conv1 activation, int8 with one scale folded
    into conv2's affine under ``quantize``."""
    t, m, c = 12, 16, 64
    _, _, _, w2, ab2 = _block_case(t, m, c, c, seed=3 + pt)
    act = np.abs(np.random.default_rng(pt).normal(size=(2, t, m, c)))
    act = act.astype(np.float32)
    if quantize:
        xs = float(act.max()) / 127.0
        xq = np.clip(np.round(act / xs), -127, 127).astype(np.int8)
        jx, tx = jnp.asarray(xq), torch.from_numpy(xq)
        deq = xq.astype(np.float32) * np.float32(xs)
    else:
        xs = None
        jx, tx = _bf16(act)
        deq = np.asarray(jx, np.float32)
    ref = jcb.fused_pair_conv_pool(jx, None, None, jnp.asarray(w2),
                                   _jab(ab2), (pt, 2), quantize=quantize,
                                   tc=4, x_scale=xs, interpret=True)
    got = tpc.fused_pair_conv_pool(tx, None, None, torch.from_numpy(w2),
                                   _tab(ab2), (pt, 2), quantize=quantize,
                                   tc=4, x_scale=xs)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t // pt, 8, c)
    assert _rel_rms(_to_np(got), _to_np(ref)) <= (
        INT8_TOL if quantize else BF16_TOL)

    # against conv2 + BN + ReLU + pool of the dequantized input in XLA
    def conv(v):
        y = jax.lax.conv_general_dilated(
            v, jnp.asarray(w2), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.maximum(y * ab2[0] + ab2[1], 0.0)

    y = conv(jnp.asarray(deq))
    win = (1, pt, 2, 1)
    f32 = (jax.lax.reduce_window(y, 0.0, jax.lax.add, win, win, "VALID")
           / (2 * pt)
           + jax.lax.reduce_window(y, -np.inf, jax.lax.max, win, win,
                                   "VALID"))
    assert _rel_rms(_to_np(got), np.asarray(f32)) < 0.05


def test_pair_conv_pool_needs_whole_chunks():
    x = torch.zeros(1, 10, 8, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64)
    ab = (torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError):
        tpc.fused_pair_conv_pool(x, w, ab, w, ab, tc=4)
    with pytest.raises(ValueError):        # int8 input without quantize
        tpc.fused_pair_conv_pool(x.to(torch.int8), None, None, w, ab, tc=5)
    assert tpc.pick_tc(500, 16, 2) == 100 and tpc.pick_tc(1008, 32, 2) == 56


# -------------------------------------------------- row 6: fused_block2

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("conv1", ["banded", "windows"])
def test_block2_small_matches_pallas(mode, conv1):
    """Odd T: padded to the chunk grid, masked, the odd frame dropped."""
    quantize, jdt, tdt = MODES[mode]
    t, tc = 19, 6
    x, w1, ab1, w2, ab2 = _block_case(t, 8, 64, 128, seed=19)
    jx, tx = _inputs(x, mode)
    ref = jbs.fused_block2(jx, jnp.asarray(w1), _jab(ab1), jnp.asarray(w2),
                           _jab(ab2), quantize=quantize, tc=tc,
                           compute_dtype=jdt, conv1=conv1, interpret=True)
    got = tb6.fused_block2(tx, torch.from_numpy(w1), _tab(ab1),
                           torch.from_numpy(w2), _tab(ab2),
                           quantize=quantize, tc=tc, compute_dtype=tdt,
                           conv1=conv1)
    assert got.shape == (2, t // 2, 4, 128)
    f32 = xla_ref(jnp.asarray(jx, jnp.float32), jnp.asarray(w1), _jab(ab1),
                  jnp.asarray(w2), _jab(ab2))
    _check(mode, got, ref, f32)


def test_block2_small_default_chunk_even_t():
    x, w1, ab1, w2, ab2 = _block_case(100, 4, 64, 128, seed=2)
    jx, tx = _bf16(x)
    assert tb6.default_tc(100) == 50 and tb6.default_tc(98) == 2
    ref = jbs.fused_block2(jx, jnp.asarray(w1), _jab(ab1), jnp.asarray(w2),
                           _jab(ab2), interpret=True)
    got = tb6.fused_block2(tx, torch.from_numpy(w1), _tab(ab1),
                           torch.from_numpy(w2), _tab(ab2))
    assert got.dtype == torch.bfloat16
    _check("int8", got, ref)


# -------------------------------------------------- row 7: fused_block1

@pytest.mark.parametrize("mode", list(MODES))
def test_block1_small_matches_pallas(mode):
    quantize, jdt, tdt = MODES[mode]
    t = 37                                  # odd, 3 chunks of tc = 16
    x, w1, ab1, w2, ab2 = _block_case(t, 64, 1, 64, seed=t)
    jx, tx = _inputs(x[..., 0], mode)
    ref = jbs.fused_block1(jx, jnp.asarray(w1), _jab(ab1), jnp.asarray(w2),
                           _jab(ab2), quantize=quantize, tc=16,
                           compute_dtype=jdt, interpret=True)
    got = tb7.fused_block1(tx, torch.from_numpy(w1), _tab(ab1),
                           torch.from_numpy(w2), _tab(ab2),
                           quantize=quantize, tc=16, compute_dtype=tdt)
    assert got.shape == (2, t // 2, 32, 64)
    f32 = xla_ref(jnp.asarray(jx, jnp.float32)[..., None], jnp.asarray(w1),
                  _jab(ab1), jnp.asarray(w2), _jab(ab2))
    _check(mode, got, ref, f32)


def test_conv1_im2col_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 21, 64)).astype(np.float32)
    ref = np.asarray(jbs.conv1_im2col(jnp.asarray(x), 48))
    got = tb7.conv1_im2col(torch.from_numpy(x), 48).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tb7.default_tc(1001) == 48 and tb7.default_tc(21) == 48


# ------------------------------- row 2: fused_block1_pair(quantize=True)

@pytest.mark.parametrize("t,tc", [(37, 16), (64, 32)])
def test_block1_all_int8_matches_pallas(t, tc):
    """The per-chunk y1 scale makes the result depend on tc: at equal tc
    the port agrees with the JAX kernel, at another tc it does not."""
    x, w1, ab1, w2, ab2 = _block_case(t, 64, 1, 64, seed=t)
    jx, tx = _bf16(x[..., 0])
    ref = jb1.fused_block1_pair(jx, jnp.asarray(w1), _jab(ab1),
                                jnp.asarray(w2), _jab(ab2), quantize=True,
                                tc=tc, interpret=True)
    args = (tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
            _tab(ab2))
    got = tb1.fused_block1_pair(*args, quantize=True, tc=tc)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t // 2, 32, 64)
    f32 = xla_ref(jnp.asarray(jx, jnp.float32)[..., None], jnp.asarray(w1),
                  _jab(ab1), jnp.asarray(w2), _jab(ab2))
    _check("int8", got, ref, f32)
    other = tb1.fused_block1_pair(*args, quantize=True, tc=48 - tc)
    assert _rel_rms(_to_np(other), _to_np(ref)) > INT8_TOL


def test_block1_all_int8_scale_sees_rows_outside_the_clip():
    """The chunk's y1 scale is taken over its conv1 rows at times
    [j tc - 1, j tc + tc], the ones outside the clip too (time -1 sees
    x[0] through the dt = 2 taps), before they are zeroed: a loud first
    frame that only those taps weigh positively sets chunk 0's scale."""
    t, tc = 37, 16
    x, w1, ab1, w2, ab2 = _block_case(t, 64, 1, 64, seed=8)
    x = 0.05 * x[..., 0]
    x[:, 0] = 5.0
    w1[:2, :, :, :8], w1[2, :, :, :8] = -0.3, 0.3
    jx, tx = _bf16(x)
    ref = jb1.fused_block1_pair(jx, jnp.asarray(w1), _jab(ab1),
                                jnp.asarray(w2), _jab(ab2), quantize=True,
                                tc=tc, interpret=True)
    got = tb1.fused_block1_pair(tx, torch.from_numpy(w1), _tab(ab1),
                                torch.from_numpy(w2), _tab(ab2),
                                quantize=True, tc=tc)
    assert _rel_rms(_to_np(got), _to_np(ref)) <= INT8_TOL


def test_block1_modes_are_checked():
    x = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(3, 3, 1, 64), torch.zeros(3, 3, 64, 64)
    ab = (torch.ones(64), torch.zeros(64))
    for bad in ({"quantize": "int4"}, {"quantize": True, "tc": 40},
                {"tc": 80}):
        with pytest.raises(ValueError):
            tb1.fused_block1_pair(x, w1, ab, w2, ab, **bad)


# ------------------------- row 2: fused_block1_pair(mode="single")

_SINGLE_T, _SINGLE_TC = 37, 16


@pytest.fixture(scope="module")
def single_ref():
    """The JAX kernel's single staging (``TTG_B1_MODE=single``) in
    interpret mode at t = 37, tc = 16, once for the module: f32, and the
    serving modes on the bf16-rounded input."""
    x, w1, ab1, w2, ab2 = _block_case(_SINGLE_T, 64, 1, 64, seed=_SINGLE_T)
    jx, _ = _bf16(x[..., 0])
    jw = (jnp.asarray(w1), _jab(ab1), jnp.asarray(w2), _jab(ab2))
    out = {q: _to_np(jb1.fused_block1_pair(
        jx, *jw, quantize=q, tc=_SINGLE_TC, interpret=True, mode="single"))
        for q in (True, "conv1", False)}
    out["f32"] = _to_np(jb1.fused_block1_pair(
        jnp.asarray(x[..., 0]), *jw, quantize=False, tc=_SINGLE_TC,
        compute_dtype=jnp.float32, interpret=True, mode="single"))
    out["xla"] = np.asarray(xla_ref(jnp.asarray(x), *jw))
    return out


def test_block1_single_f32_matches_pallas(single_ref):
    """At f32 the single staging is block 1's function: the port's plain
    version in the JAX kernel's f32 mode within 1e-4 of JAX's single mode
    and of the XLA block, in either staging."""
    x, w1, ab1, w2, ab2 = _block_case(_SINGLE_T, 64, 1, 64, seed=_SINGLE_T)
    for mode in tb1.HALO:
        got = tb1.block1_plain(
            torch.from_numpy(x[..., 0]), torch.from_numpy(w1), _tab(ab1),
            torch.from_numpy(w2), _tab(ab2), quantize=False,
            tc=_SINGLE_TC, mode=mode, compute_dtype=torch.float32)
        assert got.dtype == torch.float32
        _check("f32", got, single_ref["f32"], single_ref["xla"])


@pytest.mark.parametrize("quantize", [True, "conv1", False])
def test_block1_single_matches_pallas(quantize, single_ref):
    """The serving modes: int8 within 2e-3 relative RMS of JAX's single
    mode (and < 0.05 of the f32 block), ``"conv1"`` within 5e-3 and bf16
    1e-2 (``tests/test_torch_port_kernels.py``); in ``"conv1"`` and
    ``False`` the port's single staging is the triple one's sum."""
    x, w1, ab1, w2, ab2 = _block_case(_SINGLE_T, 64, 1, 64, seed=_SINGLE_T)
    _, tx = _bf16(x[..., 0])
    args = (tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
            _tab(ab2))
    got = tb1.fused_block1_pair(*args, quantize=quantize, tc=_SINGLE_TC,
                                mode="single")
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, _SINGLE_T // 2, 32, 64)
    ref = single_ref[quantize]
    if quantize is True:
        _check("int8", got, ref, single_ref["xla"])
        return
    assert _rel_rms(_to_np(got), ref) <= (5e-3 if quantize else BF16_TOL)
    triple = tb1.fused_block1_pair(*args, quantize=quantize,
                                   tc=_SINGLE_TC)
    torch.testing.assert_close(got, triple, rtol=0, atol=0)


def test_block1_single_int8_scale_sees_its_halo():
    """Under ``quantize=True`` the single staging takes chunk j's y1 scale
    over times [j tc - 2, j tc + tc + 1], two rows more than the triple
    staging: a loud frame at t = 34 that only the dt = 2 taps weigh
    positively makes y1 at t = 33 chunk 1's maximum in the single window
    alone, so there the two modes differ and only the single one agrees
    with JAX's."""
    t, tc = _SINGLE_T, _SINGLE_TC
    x, w1, ab1, w2, ab2 = _block_case(t, 64, 1, 64, seed=8)
    x = 0.05 * x[..., 0]
    x[:, 34] = 5.0
    w1[:2, :, :, :8], w1[2, :, :, :8] = -0.3, 0.3
    jx, tx = _bf16(x)
    ref = jb1.fused_block1_pair(jx, jnp.asarray(w1), _jab(ab1),
                                jnp.asarray(w2), _jab(ab2), quantize=True,
                                tc=tc, interpret=True, mode="single")
    args = (tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
            _tab(ab2))
    single = tb1.fused_block1_pair(*args, quantize=True, tc=tc,
                                   mode="single")
    triple = tb1.fused_block1_pair(*args, quantize=True, tc=tc)
    assert _rel_rms(_to_np(single), _to_np(ref)) <= INT8_TOL
    assert _rel_rms(_to_np(triple), _to_np(ref)) > INT8_TOL


# ------------------------------------------------- the model, block 1 int8

def _jax_outputs(model, variables, batch):
    """(audio embedding, pre-sigmoid logits, frame_sim, block 1's
    output)."""
    out, inter = model.apply(variables, batch, train=False,
                             capture_intermediates=True,
                             mutable=["intermediates"])
    inter = inter["intermediates"]
    audio_inter = inter["audio_encoder"]
    emb = np.asarray(audio_inter["__call__"][0]["embedding"])
    audio = np.asarray(inter["audio_proj"]["__call__"][0], np.float64)
    text = np.asarray(inter["text_proj"]["__call__"][0], np.float64)
    logit = np.einsum("btd,bd->bt", audio, text) / np.sqrt(audio.shape[-1])
    return (emb, logit, np.asarray(out["frame_sim"]),
            np.asarray(audio_inter["conv_block1"]["__call__"][0],
                       np.float32))


def test_block1_int8_serving_matches_jax(variables, monkeypatch):
    monkeypatch.setenv("TTG_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("TTG_FUSED_CONV", "int8")
    monkeypatch.setenv("TTG_B1_QUANT", "1")
    batch = _batch()
    j_emb, j_logit, j_sim, j_b1 = _jax_outputs(
        _jax_model(jnp.bfloat16), variables, batch)
    model = BiEncoder(Cnn8Rnn(dtype=torch.bfloat16, conv_mode="int8",
                              block1_quant="int8"),
                      EmbeddingAgg(_VOCAB, _EMBED), DotProduct(),
                      shared_dim=_EMBED, add_proj=True, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model))
    seen = []
    blk = model.audio_encoder.conv_block1
    blk.register_forward_hook(lambda mod, args, out: seen.append(
        (args[0], out)))
    emb, logit, sim, _ = _port_outputs(model, batch)
    x1, b1 = seen[0]
    assert _rel_rms(_to_np(b1), j_b1) <= INT8_TOL
    assert _rel_rms(emb, j_emb) <= 2e-2
    assert _rel_rms(logit, j_logit) <= 2e-2
    assert np.max(np.abs(sim - j_sim)) <= 5e-3
    # the default block-1 mode on the same input is another function
    default = ConvBlock(1, 64, "int8")
    default.load_state_dict(blk.state_dict())
    with torch.no_grad():
        mixed = default.eval()(x1)
    assert _rel_rms(_to_np(mixed), j_b1) > INT8_TOL


def test_flagship_model_sets_the_block1_mode():
    """The mode is the model's: ``flagship_model`` passes it to every
    block, and a second model keeps its own."""
    kw = {"device": "cpu", "vocab_size": _VOCAB, "embed_dim": _EMBED,
          "shared_dim": _EMBED}
    int8 = flagship_model(block1_quant="int8", block1_tc=32, **kw)
    single = flagship_model(block1_quant="int8", block1_mode="single", **kw)
    default = flagship_model(**kw)
    for model, mode in ((int8, ("int8", 32, "triple")),
                        (single, ("int8", 48, "single")),
                        (default, ("conv1", 48, "triple"))):
        enc = model.audio_encoder
        assert {(getattr(enc, f"conv_block{i}").block1_quant,
                 getattr(enc, f"conv_block{i}").block1_tc,
                 getattr(enc, f"conv_block{i}").block1_mode)
                for i in range(1, 5)} == {mode}
    for bad in ({"block1_quant": "1"}, {"block1_tc": 40},
                {"block1_mode": "double"}):
        with pytest.raises(ValueError):
            flagship_model(**bad, **kw)


def test_single_mode_block_runs_the_single_staging():
    """``ConvBlock(block1_quant="int8", block1_mode="single")`` serves
    block 1 through the single staging's int8 scales."""
    torch.manual_seed(0)
    blk = ConvBlock(1, 64, "int8", block1_quant="int8",
                    block1_mode="single").eval()
    x = torch.randn(2, 37, 64, 1).to(torch.bfloat16)
    w1 = blk.conv1.weight.detach().permute(2, 3, 1, 0)
    w2 = blk.conv2.weight.detach().permute(2, 3, 1, 0)
    ab1, ab2 = (tb1.fold_bn(bn.weight, bn.bias, bn.running_mean,
                            bn.running_var, bn.eps)
                for bn in (blk.bn1, blk.bn2))
    with torch.no_grad():
        got = blk(x)
        ref = tb1.fused_block1_pair(x[..., 0].contiguous(), w1, ab1, w2,
                                    ab2, quantize=True, mode="single")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
