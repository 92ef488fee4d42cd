"""Log-mel spectrogram frontend (f32 reference path).

The port of ``texttoaudiogrounding_tpu/ops/frontend.py``: the torchaudio
``MelSpectrogram`` + ``AmplitudeToDB`` semantics of the reference encoders
(reference models/audio_encoder.py:107-124 — 32 ms window, 10 ms hop, 64
slaney mels, 50-14000 Hz, ``top_db=None``; and the CDur encoder's, n_fft
2048, 40 ms window, 20 ms hop, 64 HTK mels).  The windowed DFT is one
matrix product of the framed waveform against the window-weighted
real/imag DFT basis, as the JAX package computes it with a strided
convolution (:func:`power_spectrogram`); :func:`log_mel_spectrogram_numpy`
is the float64 NumPy golden.  The bf16 serving frontend is the
hand-written kernel in ``ops/kernels/logmel.py``.

Frame count with center (reflect) padding is ``floor(num_samples / hop) +
1``, the length arithmetic the reference's encoders rely on.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LogMelConfig:
    sample_rate: int = 32000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 320
    n_mels: int = 64
    f_min: float = 0.0
    f_max: float | None = None
    norm: str | None = None          # None or "slaney"
    mel_scale: str = "htk"           # "htk" or "slaney"
    amin: float = 1e-10              # AmplitudeToDB clamp floor
    top_db: float | None = None

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def effective_f_max(self) -> float:
        return self.f_max if self.f_max is not None else self.sample_rate / 2


def cnn8rnn_mel_config(sample_rate: int = 32000) -> LogMelConfig:
    """Frontend of the Cnn8Rnn encoder: win = 32 ms = n_fft, hop = 10 ms,
    f 50..14000 (32 kHz) with slaney norm + slaney scale."""
    win = int(0.032 * sample_rate)
    f_max = 14000.0 if sample_rate == 32000 else sample_rate / 2
    return LogMelConfig(
        sample_rate=sample_rate, n_fft=win, win_length=win,
        hop_length=int(0.010 * sample_rate), n_mels=64,
        f_min=50.0, f_max=f_max, norm="slaney", mel_scale="slaney",
    )


def cdur_mel_config(sample_rate: int = 32000) -> LogMelConfig:
    """Frontend of the CDur CRNN encoder (JAX ``ops/frontend.py:68-76``):
    n_fft 2048, a 40 ms Hann window centred in it, 20 ms hop, the
    torchaudio defaults otherwise (HTK scale, no norm, full band)."""
    return LogMelConfig(
        sample_rate=sample_rate, n_fft=2048,
        win_length=40 * sample_rate // 1000,
        hop_length=20 * sample_rate // 1000, n_mels=64,
    )


def _hz_to_mel(freq: np.ndarray, mel_scale: str) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(freq / min_log_hz) / logstep, mels)


def _mel_to_hz(mels: np.ndarray, mel_scale: str) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_sp * mels
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(cfg: LogMelConfig) -> np.ndarray:
    """Triangular mel filterbank ``[n_freqs, n_mels]`` (torchaudio
    ``melscale_fbanks`` semantics, incl. slaney area normalization)."""
    all_freqs = np.linspace(0.0, cfg.sample_rate / 2, cfg.n_freqs)
    m_min = _hz_to_mel(np.array(cfg.f_min), cfg.mel_scale)
    m_max = _hz_to_mel(np.array(cfg.effective_f_max), cfg.mel_scale)
    m_pts = np.linspace(m_min, m_max, cfg.n_mels + 2)
    f_pts = _mel_to_hz(m_pts, cfg.mel_scale)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if cfg.norm == "slaney":
        enorm = 2.0 / (f_pts[2:cfg.n_mels + 2] - f_pts[:cfg.n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def _hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def _padded_window(cfg: LogMelConfig) -> np.ndarray:
    """Window zero-padded centered to n_fft (torch.stft semantics)."""
    win = _hann_window(cfg.win_length)
    if cfg.win_length == cfg.n_fft:
        return win
    pad_left = (cfg.n_fft - cfg.win_length) // 2
    out = np.zeros(cfg.n_fft, dtype=np.float64)
    out[pad_left:pad_left + cfg.win_length] = win
    return out


@functools.lru_cache(maxsize=8)
def _dft_kernel(cfg: LogMelConfig) -> np.ndarray:
    """Windowed DFT basis ``[n_fft, 2 * n_freqs]``: column k of the first
    half is ``w[n] cos(2 pi n k / n_fft)``, the second half the negated
    sine part."""
    n = np.arange(cfg.n_fft, dtype=np.float64)[:, None]
    k = np.arange(cfg.n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / cfg.n_fft
    win = _padded_window(cfg)[:, None]
    real = win * np.cos(ang)
    imag = -win * np.sin(ang)
    return np.concatenate([real, imag], axis=1).astype(np.float32)


def num_frames(num_samples, hop_length: int):
    """Frame count with center padding: floor(n / hop) + 1."""
    return num_samples // hop_length + 1


def frame_waveform(waveform: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """``[B, N] -> [B, T, n_fft]`` reflect-padded frames (a strided view)."""
    pad = cfg.n_fft // 2
    x = F.pad(waveform[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(1, cfg.n_fft, cfg.hop_length)


_device_tables: dict = {}


def _tables(cfg: LogMelConfig, device: torch.device) -> tuple:
    """(DFT basis, filterbank) as f32 tensors on ``device``, made once."""
    key = (cfg, str(device))
    if key not in _device_tables:
        _device_tables[key] = (
            torch.from_numpy(_dft_kernel(cfg)).to(device),
            torch.from_numpy(mel_filterbank(cfg)).to(device))
    return _device_tables[key]


def power_spectrogram(waveform: torch.Tensor, cfg: LogMelConfig,
                      use_fft: bool = False) -> torch.Tensor:
    """``[B, N] -> [B, T, n_freqs]`` f32 power spectrogram (power 2) of
    the reflect-padded frames (JAX ``frontend.py:174``): the frames times
    the windowed DFT basis, or with ``use_fft`` the windowed frames'
    ``torch.fft.rfft``, for cross-checking."""
    frames = frame_waveform(waveform.to(torch.float32), cfg)
    if use_fft:
        win = torch.from_numpy(_padded_window(cfg).astype(np.float32)).to(
            waveform.device)
        spec = torch.fft.rfft(frames * win, n=cfg.n_fft, dim=-1)
        return spec.real ** 2 + spec.imag ** 2
    basis, _ = _tables(cfg, waveform.device)
    spec = torch.matmul(frames, basis)                  # [B, T, 2F]
    real, imag = spec[..., :cfg.n_freqs], spec[..., cfg.n_freqs:]
    return real ** 2 + imag ** 2


def log_mel_spectrogram(waveform: torch.Tensor,
                        cfg: LogMelConfig) -> torch.Tensor:
    """``[B, N] -> [B, T, n_mels]`` log-mel (dB), all in f32."""
    if cfg.top_db is not None:
        raise NotImplementedError("the Cnn8Rnn frontend uses top_db=None")
    _, fb = _tables(cfg, waveform.device)
    mel = torch.matmul(power_spectrogram(waveform, cfg), fb)
    return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))


def log_mel_spectrogram_numpy(waveform: np.ndarray,
                              cfg: LogMelConfig) -> np.ndarray:
    """The float64 NumPy golden of the log-mel (JAX ``frontend.py:247``):
    reflect-padded frames, the window, ``np.fft.rfft``, the filterbank in
    float64, dB, ``top_db`` where the config sets it."""
    waveform = np.asarray(waveform, dtype=np.float64)
    pad = cfg.n_fft // 2
    x = np.pad(waveform, ((0, 0), (pad, pad)), mode="reflect")
    t = num_frames(waveform.shape[1], cfg.hop_length)
    win = _padded_window(cfg)
    frames = np.stack(
        [x[:, i * cfg.hop_length:i * cfg.hop_length + cfg.n_fft] * win
         for i in range(t)], axis=1)
    spec = np.fft.rfft(frames, n=cfg.n_fft, axis=-1)
    power = np.abs(spec) ** 2
    mel = power @ mel_filterbank(cfg).astype(np.float64)
    out = 10.0 * np.log10(np.maximum(mel, cfg.amin))
    if cfg.top_db is not None:
        out = np.maximum(out, out.max() - cfg.top_db)
    return out
