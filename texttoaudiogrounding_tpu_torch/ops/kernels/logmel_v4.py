"""Log-mel frontend, next tile staged under the current epilogue:
``csrc/logmel_v4.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/logmel.py:175
fused_log_mel_spectrogram_v4``: row 1's function (``logmel.py:438``, the
port's ``ops/kernels/logmel.py``) and framing, bit for bit with row 1's
first design (``csrc/logmel.cu``, whose tile code it shares), on another
schedule.  The TPU kernel defers each tile's power → mel → dB epilogue so
that it overlaps the next tile's DFT; on the card each block walks several
16-frame tiles and copies the next tile's waveform samples into shared
memory (``cp.async``, two buffers) while the current tile's DFT and
epilogue run.  Like the TPU kernel it takes only configurations whose
basis fits one frequency tile (``logmel.py:225-227``).

``fused_log_mel_spectrogram_v4`` launches the kernel for a CUDA tensor and
runs row 1's plain version, :func:`logmel.log_mel_plain` (the same
function), for a CPU tensor.
"""

from __future__ import annotations

import torch

from texttoaudiogrounding_tpu_torch.ops.frontend import (
    LogMelConfig,
    num_frames,
)
from texttoaudiogrounding_tpu_torch.ops.kernels import _build, logmel

launches = 0          # kernel launches through fused_log_mel_spectrogram_v4


def check_single_tile(cfg: LogMelConfig) -> None:
    """The TPU kernel's limit: both ``[k_pad, F]`` bf16 bases, double
    buffered, within 6 MiB (``logmel.py:71 _trimmed_basis``), i.e. one
    frequency tile."""
    hop = cfg.hop_length
    k_pad = -(-cfg.n_fft // hop) * hop
    f_pad = logmel._trimmed_basis(cfg)[0].shape[1]
    if k_pad * f_pad * 2 * 2 > 6 * 2**20:
        raise ValueError(f"v4 requires a single f tile (n_fft {cfg.n_fft}, "
                         f"{f_pad} bins)")


def fused_log_mel_spectrogram_v4(waveform: torch.Tensor,
                                 cfg: LogMelConfig) -> torch.Tensor:
    """``[B, N]`` f32 → ``[B, T, n_mels]`` f32 log-mel (dB), equal to
    :func:`logmel._fused_log_mel_spectrogram_v1`."""
    global launches
    logmel._check(waveform, cfg)
    check_single_tile(cfg)
    if not waveform.is_cuda:
        return logmel.log_mel_plain(waveform, cfg)
    xb, npad = logmel.kernel_input(waveform, cfg)
    real, imag, fb = logmel._basis(cfg, waveform.device)
    b = waveform.shape[0]
    t = num_frames(waveform.shape[1], cfg.hop_length)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32,
                      device=waveform.device)
    fn = _build.function("logmel_v4", "ttg_logmel_v4", logmel._ARGS)
    err = fn(xb.data_ptr(), npad, b, t, real.data_ptr(), imag.data_ptr(),
             fb.data_ptr(), out.data_ptr(), _build.stream())
    launches += 1
    _build.check(err, "ttg_logmel_v4")
    return out
