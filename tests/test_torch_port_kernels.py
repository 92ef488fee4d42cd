"""The PyTorch port's kernels against the JAX package's Pallas kernels.

Each hand-written CUDA kernel of ``texttoaudiogrounding_tpu_torch`` has a
plain PyTorch version of its arithmetic beside it; for a CPU tensor the
kernel's wrapper runs that plain version.  Here the same inputs, made with
numpy from a seed, go through the JAX kernel (``interpret=True``) and the
port's wrapper on the CPU.  Small T and an explicit small ``tc`` give
several chunks, so the per-chunk int8 scale groups are exercised.

Tolerances (all as stated in the port's contract):
* log-mel: max |Δ| ≤ 2e-3 dB;
* bf16 blocks: relative RMS ≤ 1e-2 against the JAX kernel;
* int8 blocks: relative RMS ≤ 5e-3 against the JAX kernel, and < 0.05
  against the f32 XLA block (``tests/test_pallas_conv_block1_pair.py:51``).
The kernels themselves run only on a CUDA card; ``chip_smoke.py`` holds
each against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pallas_conv_block_small import xla_ref
from texttoaudiogrounding_tpu.ops import frontend as jfront
from texttoaudiogrounding_tpu.ops.pallas import conv_block as jcb
from texttoaudiogrounding_tpu.ops.pallas import conv_block1_pair as jb1
from texttoaudiogrounding_tpu.ops.pallas import conv_block_pair as jb2
from texttoaudiogrounding_tpu.ops.pallas import logmel as jlm
from texttoaudiogrounding_tpu_torch.ops import frontend as tfront
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as tcb
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair as tb1
from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block_pair as tb2
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel as tlm


def _rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _bf16(a):
    """numpy f32 values rounded to bf16, as (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _block_case(t, m, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, m, cin)).astype(np.float32)
    w1 = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, cout, cout)) * 0.05).astype(np.float32)
    ab = [(rng.uniform(0.5, 1.5, cout).astype(np.float32),
           (rng.normal(size=cout) * 0.1).astype(np.float32))
          for _ in range(2)]
    return x, w1, ab[0], w2, ab[1]


def _jab(ab):
    return tuple(jnp.asarray(v) for v in ab)


def _tab(ab):
    return tuple(torch.from_numpy(v) for v in ab)


def _to_np(out):
    return out.float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)


# ---------------------------------------------------------------- log-mel

@pytest.mark.parametrize("n", [8000, 12345])
def test_logmel_plain_matches_pallas(n):
    cfg = jfront.cnn8rnn_mel_config(32000)
    wave = (np.random.default_rng(n).normal(size=(2, n)) * 0.1).astype(
        np.float32)
    ref = np.asarray(jlm.fused_log_mel_spectrogram(
        jnp.asarray(wave), cfg, interpret=True))
    got = tlm.fused_log_mel_spectrogram(
        torch.from_numpy(wave), tfront.cnn8rnn_mel_config(32000)).numpy()
    assert got.shape == ref.shape == (2, n // 320 + 1, 64)
    assert np.max(np.abs(got - ref)) <= 2e-3


def test_logmel_f32_path_matches_jax():
    cfg = jfront.cnn8rnn_mel_config(32000)
    wave = (np.random.default_rng(3).normal(size=(2, 8000)) * 0.1).astype(
        np.float32)
    ref = np.asarray(jfront.log_mel_spectrogram(jnp.asarray(wave), cfg,
                                                use_pallas=False))
    got = tfront.log_mel_spectrogram(torch.from_numpy(wave),
                                     tfront.cnn8rnn_mel_config()).numpy()
    # f32 DFT products summed in another order: ~1e-5 dB
    assert np.max(np.abs(got - ref)) <= 1e-3


def test_frontend_tables_match():
    jc, tc = jfront.cnn8rnn_mel_config(32000), tfront.cnn8rnn_mel_config()
    np.testing.assert_array_equal(tfront.mel_filterbank(tc),
                                  jfront.mel_filterbank(jc))
    np.testing.assert_array_equal(tfront._dft_kernel(tc),
                                  jfront._dft_kernel(jc))
    real, imag, fb, _ = jlm._trimmed_basis(jc, 1280)
    treal, timag, tfb = tlm._trimmed_basis(tc)
    np.testing.assert_array_equal(treal, real[:1024])
    np.testing.assert_array_equal(timag, imag[:1024])
    np.testing.assert_array_equal(tfb, fb)
    assert not real[1024:].any()


# ---------------------------------------------------------------- block 1

@pytest.mark.parametrize("quantize,tol", [("conv1", 5e-3), (False, 1e-2)])
@pytest.mark.parametrize("t", [37, 64])
def test_block1_plain_matches_pallas(quantize, tol, t):
    x, w1, ab1, w2, ab2 = _block_case(t, 64, 1, 64, seed=t)
    jx, tx = _bf16(x[..., 0])
    ref = jb1.fused_block1_pair(jx, jnp.asarray(w1), _jab(ab1),
                                jnp.asarray(w2), _jab(ab2),
                                quantize=quantize, tc=16, interpret=True)
    got = tb1.fused_block1_pair(tx, torch.from_numpy(w1), _tab(ab1),
                                torch.from_numpy(w2), _tab(ab2),
                                quantize=quantize)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t // 2, 32, 64)
    assert _rel_rms(_to_np(got), _to_np(ref)) <= tol


def test_block1_int8_close_to_f32_block():
    x, w1, ab1, w2, ab2 = _block_case(37, 64, 1, 64, seed=1)
    jx, tx = _bf16(x[..., 0])
    ref = xla_ref(jnp.asarray(jx, jnp.float32)[..., None], jnp.asarray(w1),
                  _jab(ab1), jnp.asarray(w2), _jab(ab2))
    got = tb1.fused_block1_pair(tx, torch.from_numpy(w1), _tab(ab1),
                                torch.from_numpy(w2), _tab(ab2))
    assert _rel_rms(_to_np(got), _to_np(ref)) < 0.05


def test_block1_edge_mel_weight_scales():
    """The banded quantization scales mels 0 and 63 over their 6 in-band
    taps only (``conv_block1_pair.py:77-96``, ``:412-415``)."""
    w1 = np.zeros((3, 3, 1, 64), np.float32)
    w1[:, 1] = 0.1
    w1[:, 0] = 1.0                      # the dm=0 tap: out of band at mel 0
    wq, s = tb1.conv1_weights(torch.from_numpy(w1))
    band = np.asarray(jb1._conv1_w(jnp.asarray(w1)))[:, 64:-64]
    jscale = np.maximum(np.abs(band).max(axis=0), 1e-8) / 127.0
    np.testing.assert_allclose(s.numpy().reshape(-1), jscale, rtol=1e-7)
    assert s[0, 0] < s[1, 0] and s[63, 0] == s[1, 0]
    assert (wq[0, [0, 3, 6]] == 0).all() and (wq[63, [2, 5, 8]] == 0).all()


# ---------------------------------------------------------------- block 2

@pytest.mark.parametrize("quantize,tol", [(True, 5e-3), (False, 1e-2)])
@pytest.mark.parametrize("t,tc", [(20, 4), (12, 6)])
def test_block2_plain_matches_pallas(quantize, tol, t, tc):
    x, w1, ab1, w2, ab2 = _block_case(t, 8, 64, 128, seed=t + tc)
    jx, tx = _bf16(x)
    ref = jb2.fused_block2_pair(jx, jnp.asarray(w1), _jab(ab1),
                                jnp.asarray(w2), _jab(ab2),
                                quantize=quantize, tc=tc, interpret=True)
    got = tb2.fused_block2_pair(tx, torch.from_numpy(w1), _tab(ab1),
                                torch.from_numpy(w2), _tab(ab2),
                                quantize=quantize, tc=tc)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t // 2, 4, 128)
    assert _rel_rms(_to_np(got), _to_np(ref)) <= tol


def test_block2_chunk_window_scales():
    """Per-chunk input scales over the chunk's flat mel-pair window: the
    2-time halo plus one pair row on each side (T=12, tc=4, mp=2)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 1.0, size=(1, 12, 4, 64)).astype(np.float32)
    x[0, 1, 3, 7] = 50.0    # last pair of time t0 - 3 of chunk 1
    x[0, 10, 0, 0] = 20.0   # first pair of time t0 + tc + 2 of chunk 1
    s = tb2.pair_window_scale(torch.from_numpy(x), 4, 3)[0].numpy()
    np.testing.assert_allclose(s * 127.0, [50.0, 50.0, 20.0], rtol=1e-6)


def test_pick_tc_copies_match():
    assert tb2._pick_tc_pair(500, 16) == jb2._pick_tc_pair(500, 16) == 100
    for t, m, cin, cout in [(250, 16, 128, 256), (250, 8, 256, 512),
                            (25, 16, 128, 256), (50, 8, 256, 512)]:
        assert tcb._pick_tc(t, m, cin, cout, 1, 2, True) == jcb._pick_tc(
            t, m, cin, cout, 1, 2, True, jnp.bfloat16)
    with pytest.raises(ValueError):
        tb2._pick_tc_pair(499, 16)
    with pytest.raises(ValueError):
        tcb._pick_tc(125, 8, 256, 512, 1, 2, True)
    assert tcb.pick_tc(125, 8, 256, 512, 1, 2, True) == 250
    assert tb2.pick_tc_pair(499, 16, 128, True) % 2 == 0


# ------------------------------------------------------------ blocks 3-4

@pytest.mark.parametrize("quantize,tol", [(True, 5e-3), (False, 1e-2)])
@pytest.mark.parametrize("t,tc", [(12, 4), (10, 5)])
def test_block34_plain_matches_pallas(quantize, tol, t, tc):
    x, w1, ab1, w2, ab2 = _block_case(t, 8, 128, 256, seed=t * tc)
    jx, tx = _bf16(x)
    ref = jcb.fused_double_conv_pool(jx, jnp.asarray(w1), _jab(ab1),
                                     jnp.asarray(w2), _jab(ab2), (1, 2),
                                     quantize=quantize, tc=tc,
                                     interpret=True)
    got = tcb.fused_double_conv_pool(tx, torch.from_numpy(w1), _tab(ab1),
                                     torch.from_numpy(w2), _tab(ab2),
                                     (1, 2), quantize=quantize, tc=tc)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t, 4, 256)
    assert _rel_rms(_to_np(got), _to_np(ref)) <= tol


@pytest.mark.parametrize("block", ["block2", "block34"])
def test_int8_blocks_close_to_f32_block(block):
    if block == "block2":
        x, w1, ab1, w2, ab2 = _block_case(20, 8, 64, 128, seed=9)
        pool = (2, 2)
    else:
        x, w1, ab1, w2, ab2 = _block_case(12, 8, 128, 256, seed=9)
        pool = (1, 2)
    jx, tx = _bf16(x)
    ref = xla_ref(jnp.asarray(jx, jnp.float32), jnp.asarray(w1), _jab(ab1),
                  jnp.asarray(w2), _jab(ab2), pool=pool)
    args = (tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
            _tab(ab2))
    if block == "block2":
        got = tb2.fused_block2_pair(*args, quantize=True, tc=4)
    else:
        got = tcb.fused_double_conv_pool(*args, pool, quantize=True, tc=4)
    assert _rel_rms(_to_np(got), _to_np(ref)) < 0.05


def test_ragged_last_chunk_matches_whole_chunks():
    """A tc that does not divide T (the port's own rule where the JAX
    picker raises) gives the same bf16 block as whole chunks."""
    x, w1, ab1, w2, ab2 = _block_case(10, 8, 128, 256, seed=4)
    _, tx = _bf16(x)
    args = (tx, torch.from_numpy(w1), _tab(ab1), torch.from_numpy(w2),
            _tab(ab2), (1, 2))
    whole = tcb.fused_double_conv_pool(*args, quantize=False, tc=5)
    ragged = tcb.fused_double_conv_pool(*args, quantize=False, tc=4)
    np.testing.assert_array_equal(_to_np(ragged), _to_np(whole))


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(1, 4, 8, 128, dtype=torch.float32)
    w1 = torch.zeros(3, 3, 128, 256)
    w2 = torch.zeros(3, 3, 256, 256)
    ab = (torch.ones(256), torch.zeros(256))
    with pytest.raises(ValueError):
        tcb.fused_double_conv_pool(x, w1, ab, w2, ab, (1, 2), tc=2)
    with pytest.raises(ValueError):
        tcb.fused_double_conv_pool(x.to(torch.bfloat16), w1, ab, w2,
                                   (ab[0].to("meta"), ab[1]), (1, 2), tc=2)
    with pytest.raises(ValueError):            # not a block-1 mode
        tb1.fused_block1_pair(torch.zeros(1, 4, 64, dtype=torch.bfloat16),
                              torch.zeros(3, 3, 1, 64), ab,
                              torch.zeros(3, 3, 64, 64), ab, quantize="int4")
