"""Log-mel frontend, each tile's epilogue under the next pass's products:
``csrc/logmel_v4_v2.cu``.

Port of ``texttoaudiogrounding_tpu/ops/pallas/logmel.py:175
fused_log_mel_spectrogram_v4``: row 1's function (``logmel.py:438``, the
port's ``ops/kernels/logmel.py``) and framing on another schedule.  The
TPU kernel defers each tile's power → mel → dB epilogue so that it
overlaps the next tile's DFT, and is held bit for bit to its shipped
kernel.  Like the TPU kernel it takes only configurations whose basis
fits one frequency tile (``logmel.py:225-227``).

``fused_log_mel_spectrogram_v4`` launches the second design for a CUDA
tensor and runs row 1's plain version, :func:`logmel.log_mel_plain` (the
same function), for a CPU tensor.  The second design is row 1's second
design (``csrc/logmel_v2.cu``: the same pad pass, interleaved basis, band
tables and ``wgmma`` products) on v4's schedule: one persistent block an
SM walks the call's 128-frame tiles (block k takes tiles k, k + grid,
...; tile i is clip ``i // tpc``, frames from ``(i % tpc) 128``), a
producer warp keeps a ring of K stages loading across passes and tiles
(B as one bulk copy of a stage image, :func:`stage_images`),
two warpgroups run the products and form each pass's power, and three
more warps add it into the mel sums and write the dB while the next pass
runs.  Its output equals :func:`logmel.fused_log_mel_spectrogram` bit for
bit.  The first design (``csrc/logmel_v4.cu``: 16-frame tiles of row 1's
first design, the next tile's samples staged under the current epilogue,
bit for bit with ``csrc/logmel.cu``) is reachable only through
:func:`_fused_log_mel_spectrogram_v4_v1`, which ``chip_smoke.py`` times
beside it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from texttoaudiogrounding_tpu_torch.ops.frontend import (
    LogMelConfig,
    num_frames,
)
from texttoaudiogrounding_tpu_torch.ops.kernels import _build, logmel

launches = 0          # kernel launches through fused_log_mel_spectrogram_v4
launches_v1 = 0       # the first design's, through its _v1 function

MAX_WEIGHTS = 1024    # nonzero mel weights the kernel holds (csrc MAXW)


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


def stage_images(basis: np.ndarray, rows: int = 256,
                 per: int = 32) -> np.ndarray:
    """The second design's B operand as the ring holds it: the interleaved
    basis ``[2 F, n_fft]`` (:func:`logmel.interleaved_basis`) cut into
    passes of ``rows`` rows and K stages of ``per`` values (64 bytes of
    bf16), each stage ``[rows, per]`` in the 64-byte swizzle (the 8-value
    chunk c of row r at chunk ``c ^ ((r >> 1) & 3)``), stages pass-major:
    ``[passes * stages, rows, per]``."""
    n, k = basis.shape
    blk = basis.reshape(n // rows, rows, k // per, 4, per // 4)
    blk = blk.transpose(0, 2, 1, 3, 4)     # pass, stage, row, chunk, value
    r = np.arange(rows)[:, None]
    dst = np.arange(4)[None, :] ^ ((r >> 1) & 3)
    out = np.empty_like(blk)
    np.put_along_axis(out, np.broadcast_to(dst[None, None, :, :, None],
                                           blk.shape), blk, axis=3)
    return out.reshape(-1, rows, per)


_device_tables: dict = {}


def _tables(cfg: LogMelConfig, device: torch.device) -> tuple:
    """(stage images bf16, band, weights) on ``device``."""
    key = (cfg, str(device))
    if key not in _device_tables:
        real, imag, fb = logmel._trimmed_basis(cfg)
        band, weights = logmel.mel_bands(fb)
        images = stage_images(logmel.interleaved_basis(real, imag))
        _device_tables[key] = (
            torch.from_numpy(images).to(device, torch.bfloat16).contiguous(),
            torch.from_numpy(band).to(device).contiguous(),
            torch.from_numpy(weights).to(device).contiguous())
    return _device_tables[key]


def _grid(device: torch.device, ntiles: int) -> int:
    """One persistent block an SM, at most one a tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(sms, ntiles)


_ARGS = [_build.P, _build.I, _build.I, _build.P, _build.L, _build.I,
         _build.P, _build.P, _build.P, _build.I, _build.P, _build.I,
         _build.P]


def fused_log_mel_spectrogram_v4(waveform: torch.Tensor,
                                 cfg: LogMelConfig) -> torch.Tensor:
    """``[B, N]`` f32 → ``[B, T, n_mels]`` f32 log-mel (dB), equal to
    :func:`logmel.fused_log_mel_spectrogram`."""
    global launches
    logmel._check(waveform, cfg)
    check_single_tile(cfg)
    if not waveform.is_cuda:
        return logmel.log_mel_plain(waveform, cfg)
    logmel.check_kernel_config(cfg, waveform.device)
    b, n = waveform.shape
    if n <= cfg.n_fft // 2:
        raise ValueError(f"the reflect padding needs more than "
                         f"{cfg.n_fft // 2} samples, got {n}")
    wave = waveform.contiguous()
    t = num_frames(n, cfg.hop_length)
    npad = logmel.npad_v2(t, cfg)
    images, band, weights = _tables(cfg, wave.device)
    if weights.numel() > MAX_WEIGHTS:
        raise ValueError(f"the kernel holds {MAX_WEIGHTS} mel weights, the "
                         f"filterbank has {weights.numel()}")
    xpad = torch.empty(b, npad, dtype=torch.bfloat16, device=wave.device)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32,
                      device=wave.device)
    grid = _grid(wave.device, b * -(-t // logmel._TILE_V2))
    fn = _build.function("logmel_v4_v2", "ttg_logmel_v4_v2", _ARGS)
    err = fn(wave.data_ptr(), b, n, xpad.data_ptr(), npad, t,
             images.data_ptr(), band.data_ptr(), weights.data_ptr(),
             weights.numel(), out.data_ptr(), grid, _build.stream())
    launches += 1
    _build.check(err, "ttg_logmel_v4_v2")
    return out


def _fused_log_mel_spectrogram_v4_v1(waveform: torch.Tensor,
                                     cfg: LogMelConfig) -> torch.Tensor:
    """The first design (``csrc/logmel_v4.cu``) on a CUDA tensor, counted
    in ``launches_v1``; nothing served calls it.  It equals
    :func:`logmel._fused_log_mel_spectrogram_v1` bit for bit."""
    global launches_v1
    logmel._check(waveform, cfg)
    check_single_tile(cfg)
    if not waveform.is_cuda:
        raise ValueError("the first design runs on a CUDA tensor only")
    xb, npad = logmel.kernel_input(waveform, cfg)
    real, imag, fb = logmel._basis(cfg, waveform.device)
    b = waveform.shape[0]
    t = num_frames(waveform.shape[1], cfg.hop_length)
    out = torch.empty(b, t, cfg.n_mels, dtype=torch.float32,
                      device=waveform.device)
    fn = _build.function("logmel_v4", "ttg_logmel_v4", logmel._ARGS)
    err = fn(xb.data_ptr(), npad, b, t, real.data_ptr(), imag.data_ptr(),
             fb.data_ptr(), out.data_ptr(), _build.stream())
    launches_v1 += 1
    _build.check(err, "ttg_logmel_v4")
    return out
