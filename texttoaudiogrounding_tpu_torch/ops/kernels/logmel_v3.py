"""Log-mel frontend without the reflect-pad copy: ``csrc/logmel_v3_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/logmel.py:350
fused_log_mel_spectrogram_v3``, whose numerics are its own:

* no reflect-pad copy: the waveform is cast to bf16 and frame t reads
  samples ``[t hop - n_fft / 2, t hop + n_fft / 2)`` of it; the TPU kernel
  does so through four shifted basis slices (``_v3_parts``, ``:285``),
  contracting exactly ``n_fft`` rows;
* the DFT as bf16 products with f32 sums, f32 power;
* the mel projection in bf16: the power rounded to bf16 times the bf16
  filterbank, f32 sums (``:335``); row 1 projects in f32;
* the frames whose window touches the reflect padding, ``t < t_lo`` and
  ``t >= t_hi``, from the f32 plain frontend (``ops/frontend.py
  log_mel_spectrogram``, XLA in the JAX package) on the same waveform
  slices as ``:426-436``, the right one with its own reflect padding.

``fused_log_mel_spectrogram_v3`` launches the second design for a CUDA
tensor and runs :func:`log_mel_v3_plain` for a CPU tensor.  The second
design is two kernels: one pass casts the waveform to bf16, then one
launch runs row 1's wgmma DFT tiles (``csrc/logmel_v2.cu``) over the
call's interior frames, each read at ``t hop - n_fft / 2`` of that copy,
with the bf16 mel projection, and, in its first blocks, the edge frames as
a direct f32 DFT of reflect-indexed samples (:func:`tables`).  No PyTorch
op computes on its path.  The first design (``csrc/logmel_v3.cu``,
16-frame WMMA tiles, the edge frames from the plain frontend in PyTorch)
is reachable only through :func:`_fused_log_mel_spectrogram_v3_v1`, which
``chip_smoke.py`` times beside it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from texttoaudiogrounding_tpu_torch.ops.frontend import (
    LogMelConfig,
    log_mel_spectrogram,
    num_frames,
)
from texttoaudiogrounding_tpu_torch.ops.kernels import _build, logmel

launches = 0          # kernel launches through fused_log_mel_spectrogram_v3
launches_v1 = 0       # the first design's, through its _v1 function


def v3_parts(cfg: LogMelConfig) -> list:
    """The TPU kernel's DFT parts (``logmel.py:285 _v3_parts``): frame t
    is rows ``t - 2 .. t - 2 + J - 1`` of the ``[R, hop]`` waveform
    reshape, from lane ``2 hop - pad``; ``(lane_lo, lane_hi, basis_lo,
    basis_hi)`` per row."""
    hop, n_fft, pad = cfg.hop_length, cfg.n_fft, cfg.n_fft // 2
    lead = 2 * hop - pad
    parts = []
    j = 0
    while j * hop - lead < n_fft:
        lo = max(0, j * hop - lead)
        hi = min(n_fft, (j + 1) * hop - lead)
        parts.append((lo - (j * hop - lead), hi - (j * hop - lead), lo, hi))
        j += 1
    return parts


def v3_supported(cfg: LogMelConfig) -> bool:
    """``logmel.py:308 _v3_supported``: ``hop < n_fft / 2 <= 2 hop``, and
    every part's lane slice and basis rows aligned for the TPU."""
    hop, pad = cfg.hop_length, cfg.n_fft // 2
    if not (hop < pad <= 2 * hop) or cfg.n_fft % 8:
        return False
    return all(lo % 128 == 0 and blo % 8 == 0 and bhi % 8 == 0
               for lo, hi, blo, bhi in v3_parts(cfg))


def edges(n: int, cfg: LogMelConfig) -> tuple:
    """(t_lo, t_hi): the frames in ``[t_lo, t_hi)`` lie inside the clip
    (``logmel.py:426-427``)."""
    pad, hop = cfg.n_fft // 2, cfg.hop_length
    t_lo, t_hi = -(-pad // hop), (n + pad - cfg.n_fft) // hop + 1
    if t_hi <= t_lo:
        raise ValueError(f"a clip of {n} samples has no interior frame")
    return t_lo, t_hi


def _check(waveform: torch.Tensor, cfg: LogMelConfig) -> tuple:
    logmel._check(waveform, cfg)
    if not v3_supported(cfg):
        raise ValueError("the v3 framing does not support this config")
    return edges(waveform.shape[1], cfg)


def _edge_frames(waveform, cfg, t_lo, t_hi) -> tuple:
    """(frames ``[0, t_lo)``, frames ``[t_hi, T)``) from the f32 plain
    frontend on the waveform slices of ``logmel.py:428-433``."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    t = num_frames(waveform.shape[1], hop)
    left = log_mel_spectrogram(waveform[:, :(t_lo + 1) * hop + n_fft],
                               cfg)[:, :t_lo]
    right = log_mel_spectrogram(waveform[:, (t_hi - t_lo) * hop:],
                                cfg)[:, t_lo:t_lo + t - t_hi]
    return left, right


def _fb_bf16(cfg: LogMelConfig, device: torch.device) -> torch.Tensor:
    """The slaney filterbank ``[F, n_mels]`` in bf16 (``logmel.py:335``)."""
    return logmel._basis(cfg, device)[2].to(torch.bfloat16).contiguous()


def log_mel_v3_plain(waveform: torch.Tensor,
                     cfg: LogMelConfig) -> torch.Tensor:
    """The v3 arithmetic in plain PyTorch: ``[B, N] -> [B, T, 64]``."""
    t_lo, t_hi = _check(waveform, cfg)
    pad = cfg.n_fft // 2
    xz = F.pad(waveform.to(torch.bfloat16).float(), (pad, pad))
    frames = xz.unfold(1, cfg.n_fft, cfg.hop_length)[:, t_lo:t_hi]
    real, imag, _ = logmel._basis(cfg, waveform.device)
    re = torch.matmul(frames, real.float())
    im = torch.matmul(frames, imag.float())
    power = re ** 2 + im ** 2
    mel = torch.matmul(power.to(torch.bfloat16).float(),
                       _fb_bf16(cfg, waveform.device).float())
    mid = logmel._DB * torch.log(torch.clamp(mel, min=cfg.amin))
    left, right = _edge_frames(waveform, cfg, t_lo, t_hi)
    return torch.cat([left, mid, right], dim=1)


_device_v3: dict = {}


def tables(cfg: LogMelConfig, device: torch.device) -> tuple:
    """The second design's tables on ``device``: (the interleaved bf16 DFT
    basis of row 1, the bf16 filterbank's ``mel_bands`` (band, f32
    weights), the windowed f32 basis ``[n_fft, F, 2]`` (re, im) of the
    edge frames, the f32 filterbank's ``mel_bands``, and the bins ``(lo,
    hi)`` that cover every band)."""
    key = (cfg, str(device))
    if key not in _device_v3:
        real, imag, fb = logmel._trimmed_basis(cfg)
        fb16 = torch.from_numpy(fb).to(torch.bfloat16).float().numpy()
        band16, w16 = logmel.mel_bands(fb16)
        band, w = logmel.mel_bands(fb)
        used = band[band[:, 1] > band[:, 0]]
        dev = functools.partial(torch.as_tensor, device=device)
        _device_v3[key] = (
            logmel._tables_v2(cfg, device)[0], dev(band16), dev(w16),
            dev(np.ascontiguousarray(np.stack([real, imag], axis=-1))),
            dev(band), dev(w), (int(used[:, 0].min()), int(used[:, 1].max())))
    return _device_v3[key]


def npad_v3(t_hi: int, cfg: LogMelConfig) -> int:
    """Samples a clip of the second design's bf16 copy: the last interior
    frame's window, rounded up to 8 (16-byte pieces).  The tiles run over
    the call's interior frames clip after clip, and a tile's rows past the
    last frame read that frame again."""
    last = (t_hi - 1) * cfg.hop_length + cfg.n_fft // 2
    return -(-last // 8) * 8


def _check_kernel(waveform: torch.Tensor, cfg: LogMelConfig) -> tuple:
    t_lo, t_hi = _check(waveform, cfg)
    logmel.check_kernel_config(cfg, waveform.device)
    if cfg.amin != 1e-10:
        raise ValueError("the kernel is built for amin 1e-10")
    return t_lo, t_hi


_P, _I, _L = _build.P, _build.I, _build.L
_ARGS = [_P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_V2_ARGS = [_P, _I, _L, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
            _P, _P]


def fused_log_mel_spectrogram_v3(waveform: torch.Tensor,
                                 cfg: LogMelConfig) -> torch.Tensor:
    """``[B, N]`` f32 → ``[B, T, n_mels]`` f32 log-mel (dB), v3's
    numerics."""
    global launches
    t_lo, t_hi = _check(waveform, cfg)
    if not waveform.is_cuda:
        return log_mel_v3_plain(waveform, cfg)
    _check_kernel(waveform, cfg)
    x = waveform.contiguous()
    b, n = x.shape
    t = num_frames(n, cfg.hop_length)
    basis, band16, w16, eb, band, w, (lo, hi) = tables(cfg, x.device)
    npad = npad_v3(t_hi, cfg)
    xb = torch.empty(b, npad, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32, device=x.device)
    fn = _build.function("logmel_v3_v2", "ttg_logmel_v3_v2", _V2_ARGS)
    err = fn(x.data_ptr(), b, n, xb.data_ptr(), npad, t, t_lo, t_hi,
             basis.data_ptr(), band16.data_ptr(), w16.data_ptr(),
             eb.data_ptr(), band.data_ptr(), w.data_ptr(), lo, hi,
             out.data_ptr(), _build.stream())
    launches += 1
    _build.check(err, "ttg_logmel_v3_v2")
    return out


def _fused_log_mel_spectrogram_v3_v1(waveform: torch.Tensor,
                                     cfg: LogMelConfig) -> torch.Tensor:
    """The first design (``csrc/logmel_v3.cu`` for the interior frames,
    the plain frontend in PyTorch for the edge frames) on a CUDA tensor,
    counted in ``launches_v1``; nothing served calls it.
    ``chip_smoke.py`` holds the second design to it."""
    global launches_v1
    t_lo, t_hi = _check(waveform, cfg)
    if not waveform.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    _check_kernel(waveform, cfg)
    x = waveform.contiguous()
    b, n = x.shape
    t = num_frames(n, cfg.hop_length)
    real, imag, _ = logmel._basis(cfg, x.device)
    fb = _fb_bf16(cfg, x.device)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32, device=x.device)
    fn = _build.function("logmel_v3", "ttg_logmel_v3", _ARGS)
    err = fn(x.data_ptr(), n, b, t, t_lo, t_hi, real.data_ptr(),
             imag.data_ptr(), fb.data_ptr(), out.data_ptr(), _build.stream())
    launches_v1 += 1
    _build.check(err, "ttg_logmel_v3")
    left, right = _edge_frames(x, cfg, t_lo, t_hi)
    out[:, :t_lo] = left
    out[:, t_hi:] = right
    return out
