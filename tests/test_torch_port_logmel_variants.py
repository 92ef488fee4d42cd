"""The port's log-mel variants against the JAX kernels (interpret mode).

Two clips of 1.5 s at 32 kHz (numpy-seeded noise, 151 frames each) go
through the JAX kernel and the port's wrapper on the CPU, which runs its
plain PyTorch version:

* row 9, ``fused_log_mel_spectrogram_v3``: the interior frames within
  0.05 dB max and 2e-3 dB mean of JAX v3 (bf16 products summed in another
  order, and the bf16 rounding of the power before the mel projection
  flips with them), the four edge frames (0, 1, 149, 150: the f32 plain
  frontend on the same waveform slices in both) within 1e-3 dB;
* row 10, ``fused_log_mel_spectrogram_v4``: equal to the port's row 1
  plain version bit for bit (the same function, as on the TPU,
  ``tests/test_pallas_logmel.py``), and within row 1's tolerance of JAX v4
  (2e-3 dB, ``tests/test_torch_port_kernels.py``).
The kernels run only on a CUDA card; ``chip_smoke.py`` holds each against
its plain version there (row 10 bit for bit against row 1's kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.ops import frontend as jfront
from texttoaudiogrounding_tpu.ops.pallas import logmel as jlm
from texttoaudiogrounding_tpu_torch.ops import frontend as tfront
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel as tlm
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel_v3 as tv3
from texttoaudiogrounding_tpu_torch.ops.kernels import logmel_v4 as tv4

_N = 48000


@pytest.fixture(scope="module")
def wave():
    return (np.random.default_rng(9).normal(size=(2, _N)) * 0.1).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_out(wave):
    """The JAX kernels in interpret mode, run once for the module."""
    cfg = jfront.cnn8rnn_mel_config(32000)
    return {name: np.asarray(fn(jnp.asarray(wave), cfg, interpret=True))
            for name, fn in (("v3", jlm.fused_log_mel_spectrogram_v3),
                             ("v4", jlm.fused_log_mel_spectrogram_v4))}


def test_v3_matches_pallas(wave, jax_out):
    cfg = tfront.cnn8rnn_mel_config()
    got = tv3.fused_log_mel_spectrogram_v3(torch.from_numpy(wave),
                                           cfg).numpy()
    ref = jax_out["v3"]
    t_lo, t_hi = tv3.edges(_N, cfg)
    assert (t_lo, t_hi) == (2, 149)
    assert got.shape == ref.shape == (2, _N // 320 + 1, 64)
    d = np.abs(got - ref)
    mid = d[:, t_lo:t_hi]
    assert mid.max() <= 0.05 and mid.mean() <= 2e-3, (mid.max(), mid.mean())
    edge = np.concatenate([d[:, :t_lo], d[:, t_hi:]], axis=1)
    assert edge.shape[1] == 4 and edge.max() <= 1e-3


def test_v3_is_its_own_function(wave):
    """v3's bf16 mel projection and plain edge frames: another function
    than row 1 (its interior frames move by more than row 1's 2e-3 dB
    tolerance), within the JAX test's 0.15 dB of the f32 frontend."""
    cfg = tfront.cnn8rnn_mel_config()
    x = torch.from_numpy(wave)
    v3 = tv3.log_mel_v3_plain(x, cfg).numpy()
    row1 = tlm.log_mel_plain(x, cfg).numpy()
    f32 = tfront.log_mel_spectrogram(x, cfg).numpy()
    assert np.abs(v3 - row1).max() > 2e-3
    assert np.abs(v3 - f32).max() < 0.15
    np.testing.assert_allclose(v3[:, :2], f32[:, :2], atol=1e-4)


def test_v4_is_row1(wave, jax_out):
    cfg = tfront.cnn8rnn_mel_config()
    x = torch.from_numpy(wave)
    got = tv4.fused_log_mel_spectrogram_v4(x, cfg)
    torch.testing.assert_close(got, tlm.log_mel_plain(x, cfg), rtol=0,
                               atol=0)
    assert np.max(np.abs(got.numpy() - jax_out["v4"])) <= 2e-3


def test_variants_reject_what_jax_rejects():
    x = torch.zeros(1, 8000)
    cdur = tfront.LogMelConfig(n_fft=2048, win_length=2048, hop_length=320)
    assert not tv3.v3_supported(cdur)
    assert tv3.v3_supported(tfront.cnn8rnn_mel_config())
    assert tv3.v3_parts(tfront.cnn8rnn_mel_config()) == [
        (128, 320, 0, 192), (0, 320, 192, 512), (0, 320, 512, 832),
        (0, 192, 832, 1024)]
    with pytest.raises(ValueError):
        tv3.fused_log_mel_spectrogram_v3(x, cdur)
    with pytest.raises(ValueError):            # no interior frame
        tv3.fused_log_mel_spectrogram_v3(torch.zeros(1, 600),
                                         tfront.cnn8rnn_mel_config())
    big = tfront.LogMelConfig(n_fft=4096, win_length=4096, hop_length=320,
                              f_max=16000.0)
    with pytest.raises(ValueError):            # two frequency tiles
        tv4.fused_log_mel_spectrogram_v4(x, big)
    with pytest.raises(ValueError):            # f64 waveform
        tv4.fused_log_mel_spectrogram_v4(x.double(),
                                         tfront.cnn8rnn_mel_config())
