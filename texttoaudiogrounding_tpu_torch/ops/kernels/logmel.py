"""Fused log-mel frontend (serving path): ``csrc/logmel_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/logmel.py:438
fused_log_mel_spectrogram``: the waveform is reflect-padded in f32 and cast
to bf16, the windowed DFT runs as bf16 products with f32 accumulation
against a basis trimmed to the 512 bins below the last mel-active one,
then f32 power, f32 mel projection and dB.  The padded waveform is the
only intermediate in device memory; the kernel reads its frames in place.

``fused_log_mel_spectrogram`` launches the kernel for a CUDA tensor and
runs :func:`log_mel_plain`, the same arithmetic in plain PyTorch, for a
CPU tensor.  The kernel is the second design, ``csrc/logmel_v2.cu``: one
wide pass writes the padded bf16 waveform, and a wgmma GEMM takes 128
frames × all bins a block (the basis laid out by
:func:`interleaved_basis`), with power in registers and a band-limited mel
projection (:func:`mel_bands`).  The first design (``csrc/logmel.cu``,
16-frame WMMA tiles, :func:`kernel_input`'s PyTorch padding) is reachable
only through :func:`_fused_log_mel_spectrogram_v1`: ``chip_smoke.py``
times it beside the second, and the first designs of rows 9 and 10
(``logmel_v3``, ``logmel_v4``), which share its tile code
(``csrc/logmel.cuh``), are held to it.  Row 10's second design
(``csrc/logmel_v4_v2.cu``) is held to this module's second design.
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
launches_v1 = 0       # the first design's, through its _v1 function

_TILE = 16            # frames per block (csrc/logmel.cu)
_TILE_V2 = 128        # frames per block (csrc/logmel_v2.cu)
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
    """(the bf16 reflect-padded waveform ``[B, npad]``, npad) that row 1's
    first design and row 10 read their 16-frame tiles from."""
    check_kernel_config(cfg, waveform.device)
    t = num_frames(waveform.shape[1], cfg.hop_length)
    rows = -(-t // _TILE) * _TILE
    npad = -(-((rows - 1) * cfg.hop_length + cfg.n_fft) // 16) * 16
    return _padded_bf16(waveform.contiguous(), cfg, npad), npad


def interleaved_basis(real: np.ndarray, imag: np.ndarray) -> np.ndarray:
    """The second design's DFT basis ``[2 F, n_fft]``: row 2f is bin f's
    real column, row 2f + 1 its imaginary one (K-major rows, so that a
    thread's accumulator pair is one bin's (re, im))."""
    out = np.empty((2 * real.shape[1], real.shape[0]), real.dtype)
    out[0::2] = real.T
    out[1::2] = imag.T
    return out


def mel_bands(fb: np.ndarray) -> tuple:
    """Each mel's nonzero filter weights: (``band`` int32 ``[n_mels, 3]``
    = first bin, end bin, offset into ``weights``; ``weights`` f32, the
    bins ``[first, end)`` of each mel in turn).  A mel without one has an
    empty band (0, 0)."""
    band = np.zeros((fb.shape[1], 3), np.int32)
    weights = []
    off = 0
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        band[m] = (lo, hi, off)
        weights.append(fb[lo:hi, m])
        off += hi - lo
    return band, np.concatenate(weights).astype(np.float32)


_device_v2: dict = {}


def _tables_v2(cfg: LogMelConfig, device: torch.device) -> tuple:
    """(interleaved bf16 basis, band, weights) on ``device``."""
    key = (cfg, str(device))
    if key not in _device_v2:
        real, imag, fb = _trimmed_basis(cfg)
        band, weights = mel_bands(fb)
        _device_v2[key] = (
            torch.from_numpy(interleaved_basis(real, imag)).to(
                device, torch.bfloat16).contiguous(),
            torch.from_numpy(band).to(device).contiguous(),
            torch.from_numpy(weights).to(device).contiguous())
    return _device_v2[key]


def npad_v2(t: int, cfg: LogMelConfig) -> int:
    """Samples of the second design's padded clip: every frame of the last
    128-frame tile, rounded up to 8 (16-byte pieces)."""
    rows = -(-t // _TILE_V2) * _TILE_V2
    return -(-((rows - 1) * cfg.hop_length + cfg.n_fft) // 8) * 8


_V2_ARGS = [_build.P, _build.I, _build.I, _build.P, _build.L, _build.I,
            _build.P, _build.P, _build.P, _build.P, _build.P]


def fused_log_mel_spectrogram(waveform: torch.Tensor,
                              cfg: LogMelConfig) -> torch.Tensor:
    """``[B, N]`` f32 → ``[B, T, n_mels]`` f32 log-mel (dB)."""
    global launches
    _check(waveform, cfg)
    if not waveform.is_cuda:
        return log_mel_plain(waveform, cfg)
    check_kernel_config(cfg, waveform.device)
    b, n = waveform.shape
    if n <= cfg.n_fft // 2:
        raise ValueError(f"the reflect padding needs more than "
                         f"{cfg.n_fft // 2} samples, got {n}")
    wave = waveform.contiguous()
    t = num_frames(n, cfg.hop_length)
    npad = npad_v2(t, cfg)
    basis, band, weights = _tables_v2(cfg, waveform.device)
    xpad = torch.empty(b, npad, dtype=torch.bfloat16, device=wave.device)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32,
                      device=wave.device)
    fn = _build.function("logmel_v2", "ttg_logmel_v2", _V2_ARGS)
    err = fn(wave.data_ptr(), b, n, xpad.data_ptr(), npad, t,
             basis.data_ptr(), band.data_ptr(), weights.data_ptr(),
             out.data_ptr(), _build.stream())
    launches += 1
    _build.check(err, "ttg_logmel_v2")
    return out


def _fused_log_mel_spectrogram_v1(waveform: torch.Tensor,
                                  cfg: LogMelConfig) -> torch.Tensor:
    """The first design (``csrc/logmel.cu``) on a CUDA tensor, counted in
    ``launches_v1``; nothing served calls it.  The first designs of rows 9
    and 10 are held to it, and ``chip_smoke.py`` times the second design
    beside it."""
    global launches_v1
    _check(waveform, cfg)
    if not waveform.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    xb, npad = kernel_input(waveform, cfg)
    real, imag, fb = _basis(cfg, waveform.device)
    b = waveform.shape[0]
    t = num_frames(waveform.shape[1], cfg.hop_length)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32,
                      device=waveform.device)
    fn = _build.function("logmel", "ttg_logmel", _ARGS)
    err = fn(xb.data_ptr(), npad, b, t, real.data_ptr(), imag.data_ptr(),
             fb.data_ptr(), out.data_ptr(), _build.stream())
    launches_v1 += 1
    _build.check(err, "ttg_logmel")
    return out
