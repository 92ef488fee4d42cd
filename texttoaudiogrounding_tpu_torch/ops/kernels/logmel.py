"""Fused log-mel frontend (serving path): ``csrc/logmel.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/logmel.py:438
fused_log_mel_spectrogram``: the waveform is reflect-padded in f32 and cast
to bf16, the windowed DFT runs as bf16 products with f32 accumulation
against a basis trimmed to the 512 bins below the last mel-active one,
then f32 power, f32 mel projection and dB.  The padded waveform is the
only intermediate in device memory; the kernel reads its frames in place.

``fused_log_mel_spectrogram`` launches the kernel for a CUDA tensor and
runs :func:`log_mel_plain`, the same arithmetic in plain PyTorch, for a
CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.frontend import (
    LogMelConfig,
    _dft_kernel,
    mel_filterbank,
    num_frames,
)
from texttoaudiogrounding_tpu_torch.ops.kernels import _build

launches = 0          # kernel launches through fused_log_mel_spectrogram

_TILE = 16            # frames per block (csrc/logmel.cu)
_F = 512              # retained DFT bins
_DB = float(10.0 / np.log(10.0))


@functools.lru_cache(maxsize=8)
def _trimmed_basis(cfg: LogMelConfig) -> tuple:
    """(real [n_fft, F], imag [n_fft, F], fb [F, n_mels]) as f32 numpy.

    F is the highest bin with nonzero mel weight rounded up to 256
    (``logmel.py:71 _trimmed_basis``); bins past it carry zero mel weight.
    """
    kernel = _dft_kernel(cfg)
    n_freqs = cfg.n_freqs
    fb_full = mel_filterbank(cfg)
    hi = int(np.max(np.nonzero(fb_full.sum(axis=1))[0])) + 1
    f_pad = -(-hi // 256) * 256
    m = min(f_pad, n_freqs)
    real = np.zeros((cfg.n_fft, f_pad), np.float32)
    imag = np.zeros((cfg.n_fft, f_pad), np.float32)
    real[:, :m] = kernel[:, :m]
    imag[:, :m] = kernel[:, n_freqs:n_freqs + m]
    fb = np.zeros((f_pad, cfg.n_mels), np.float32)
    fb[:m] = fb_full[:m]
    return real, imag, fb


_device_basis: dict = {}


def _basis(cfg: LogMelConfig, device: torch.device) -> tuple:
    key = (cfg, str(device))
    if key not in _device_basis:
        real, imag, fb = _trimmed_basis(cfg)
        _device_basis[key] = (
            torch.from_numpy(real).to(device, torch.bfloat16).contiguous(),
            torch.from_numpy(imag).to(device, torch.bfloat16).contiguous(),
            torch.from_numpy(fb).to(device).contiguous())
    return _device_basis[key]


def _check(waveform: torch.Tensor, cfg: LogMelConfig) -> None:
    if waveform.dim() != 2 or waveform.dtype != torch.float32:
        raise ValueError("waveform must be [B, N] float32")
    if cfg.top_db is not None:
        raise NotImplementedError("fused kernel supports top_db=None only")


def _padded_bf16(waveform: torch.Tensor, cfg: LogMelConfig,
                 length: int) -> torch.Tensor:
    """Reflect-padded waveform cast to bf16, zero-extended or cut to
    ``length`` samples."""
    pad = cfg.n_fft // 2
    x = F.pad(waveform[:, None], (pad, pad), mode="reflect")[:, 0]
    out = torch.zeros(waveform.shape[0], length, dtype=torch.bfloat16,
                      device=waveform.device)
    n = min(length, x.shape[1])
    out[:, :n] = x[:, :n].to(torch.bfloat16)
    return out


def log_mel_plain(waveform: torch.Tensor, cfg: LogMelConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``[B, N] -> [B, T, 64]``."""
    _check(waveform, cfg)
    t = num_frames(waveform.shape[1], cfg.hop_length)
    xb = _padded_bf16(waveform, cfg, waveform.shape[1] + cfg.n_fft)
    frames = xb.float().unfold(1, cfg.n_fft, cfg.hop_length)[:, :t]
    real, imag, fb = _basis(cfg, waveform.device)
    re = torch.matmul(frames, real.float())
    im = torch.matmul(frames, imag.float())
    power = re * re + im * im
    mel = torch.matmul(power, fb)
    return _DB * torch.log(torch.clamp(mel, min=cfg.amin))


_ARGS = [_build.P, _build.L, _build.I, _build.I, _build.P, _build.P,
         _build.P, _build.P, _build.P]


def check_kernel_config(cfg: LogMelConfig, device: torch.device) -> None:
    """The kernels' geometry: n_fft 1024, hop 320, 64 mels, 512 bins."""
    if (cfg.n_fft, cfg.hop_length, cfg.n_mels) != (1024, 320, 64):
        raise ValueError("the kernel is built for n_fft 1024, hop 320, "
                         "64 mels")
    if _basis(cfg, device)[0].shape[1] != _F:
        raise ValueError(f"the kernel is built for {_F} retained bins")


def kernel_input(waveform: torch.Tensor, cfg: LogMelConfig) -> tuple:
    """(the bf16 reflect-padded waveform ``[B, npad]``, npad) that the
    kernels of rows 1 and 10 read their 16-frame tiles from."""
    check_kernel_config(cfg, waveform.device)
    t = num_frames(waveform.shape[1], cfg.hop_length)
    rows = -(-t // _TILE) * _TILE
    npad = -(-((rows - 1) * cfg.hop_length + cfg.n_fft) // 16) * 16
    return _padded_bf16(waveform.contiguous(), cfg, npad), npad


def fused_log_mel_spectrogram(waveform: torch.Tensor,
                              cfg: LogMelConfig) -> torch.Tensor:
    """``[B, N]`` f32 → ``[B, T, n_mels]`` f32 log-mel (dB)."""
    global launches
    _check(waveform, cfg)
    if not waveform.is_cuda:
        return log_mel_plain(waveform, cfg)
    xb, npad = kernel_input(waveform, cfg)
    real, imag, fb = _basis(cfg, waveform.device)
    b = waveform.shape[0]
    t = num_frames(waveform.shape[1], cfg.hop_length)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32,
                      device=waveform.device)
    fn = _build.function("logmel", "ttg_logmel", _ARGS)
    err = fn(xb.data_ptr(), npad, b, t, real.data_ptr(), imag.data_ptr(),
             fb.data_ptr(), out.data_ptr(), _build.stream())
    launches += 1
    _build.check(err, "ttg_logmel")
    return out
