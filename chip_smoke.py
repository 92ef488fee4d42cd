#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one line:

1. build: compile every kernel of ``texttoaudiogrounding_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the card's name and
   power limit as ``nvidia-smi`` reports them; then the registers, shared
   memory and spills of each kernel of the second designs
   (``conv_block_v2.cu``, ``conv_block1_v2.cu``, ``logmel_v2.cu``,
   ``gru_fwd_sm90.cu``, ``gru_bwd_sm90.cu``, ``gru_walk_sm90.cu``,
   ``bn_pool_v2.cu``, ``conv_block_wino_v2.cu``, ``conv_block_tri_v2.cu``,
   ``conv_block_mel3_v2.cu``, ``pair_conv_pool_v2.cu``) from their
   ``-Xptxas -v`` logs (also ``block1_small_v2.cu``, ``logmel_v3_v2.cu``
   and ``logmel_v4_v2.cu``);
2. kernels: run each kernel at the shapes its main path gives it against
   its plain PyTorch version on the same inputs on the card, with the
   stated tolerance, and time both with CUDA events: the four serving
   kernels at the largest request's bucket (32 clips of 10 s at 32 kHz),
   all in their second designs: row 1 (the log-mel, ``logmel_v2.cu``,
   within 2e-3 dB, its gap to the f64 log-mel reported), row 2 (block 1,
   ``conv_block1_v2.cu``, in its four modes: int8 ``True`` and
   ``single`` bit for bit to the plain version and the first design, the
   bf16 modes within 1e-2 relative RMS), rows 3 and 4 (blocks 2-4, the
   wgmma implicit GEMM, ``conv_block_v2.cu``), int8 held bit for bit to
   the plain version and to the first design; both designs timed in turns
   (v1 v2 v2 v1) in every mode and traced by launch, rows 1 and 2 beside a
   PyTorch chain (``torch.stft``; cuDNN bf16 convolutions);
   the BiGRU recurrence (forward with an f32 and a bf16 carry, backward
   with f32 and with bf16 operands, and the hoisted f32 backwards v2 and
   v3, whose walk and dWh product are also timed apart; each gradient
   held on its own) at T = 250, 2B = 64, H = 256, the forward, the
   backward and the hoisted walks on their second designs
   (``gru_fwd_sm90.cu``, ``gru_bwd_sm90.cu`` and ``gru_walk_sm90.cu``, one
   cluster launch a walk) held to their plain versions and to their first
   designs (``gru.cu``, one launch a step) with the same tolerance, each
   timed in turns (first, second, second, first) and at the latency floor
   (B = 1, H = 4), the forward and the walks also at the exchange floor
   (B = 1, H = 256), their CUDA launches a call counted by the profiler
   (1 a walk for the hoisted walks), the walks also at a ragged B = 13, at
   odd numbers of units a CTA (B = 5, H = 30 and 120) and at T = 2 within
   1e-5 of their plain versions, the forward also at a ragged B = 13 and
   at B = 128 against its plain version, its first design and, with the
   f32 carry, ``torch.nn.GRU``, at T = 2 tight enough that a bf16 forward
   without its carry roundings fails, and at odd numbers of units a CTA
   (B = 5, H = 30 and 120), the bf16-operand backward also at T = 2,
   where its bf16 roundings are held tight enough that the backward
   without them fails, beside ``torch.nn.GRU`` (cuDNN, f32 and bf16) on
   the same weights as a yardstick and a third opinion; and the training
   path's pool kernels (``dual_pool_fwd``/``_bwd``, ``bn_pool_fwd``,
   ``bn_pool_bwd`` on its second design, ``bn_pool_v2.cu``, and the batch
   statistics ``bn_pool_stats``) at the four conv blocks' outputs of a
   batch-32 x 10 s bf16 step, and block 1 in f32, beside the plain
   PyTorch chain they replace (ReLU or train-mode BN, then
   ``F.avg_pool2d + F.max_pool2d``, forward + backward) for information;
   the backward also within 1e-4 of its first design (``three_pass``,
   ``bn_pool.cu``, itself held within 1e-4 of the plain version), the
   same bits on two calls, both timed in turns and
   their CUDA launches a call counted by the profiler (2 for the second
   design), with its
   two-pass streaming floor; the statistics (var within 1e-4 relative,
   mean within 1e-5 std of plain ``batch_stats``, also on block 1's x·0.5
   + 3) beside ``torch.var_mean`` as the library call;
3. serving: ``GroundingPredictor`` over the flagship ``BiEncoder`` at full
   width (Cnn8Rnn 64/128/256/512, BiGRU 2x256, vocabulary 5000, embedding
   512, shared 512) with random weights from a numpy seed answers requests
   of several batch sizes and lengths, the largest 32 clips x 10 s; every
   kernel's launch count must rise as each sub-batch's forward requires,
   ``frame_sim`` must be finite in (0, 1] with the reference length
   arithmetic, and within 0.05 of the port's all-plain f32 path on the
   card; the audio embedding of every sub-batch, taken from the very
   forward that served the request, must lie within 5 % relative RMS of
   the plain path on the same padded input.  A batch-32 request is then
   timed and profiled on the default path (grouped-loop BiGRU) and with
   the bf16 GRU kernel opted in, and with block 1 all in int8
   (``block1_quant="int8"``, the JAX ``TTG_B1_QUANT=1``), each checked the
   same way, the latter's launch counts too, and with block 1 all in int8
   in the single staging (``block1_mode="single"``, the JAX
   ``TTG_B1_MODE=single``), held to the same contract;
4. designs: the JAX package's designs that no shipped model routes, one
   record each in one table: block 1's all-int8 mode in both stagings and
   ``fused_pair_conv_pool`` (with and without conv1, second design
   ``pair_conv_pool_v2.cu``), ``fused_block2`` (row 6, on row 3's second
   design ``conv_block_v2.cu`` at its own chunk, also at odd T: 4 clips x
   499 frames, tc 2) and ``fused_block1`` (row 7, second design
   ``block1_small_v2.cu``) on the batch-32 request's block-1 input (the
   bn0 output) and output with the served model's weights, beside the
   routed rows 2 / 3; the Winograd
   block (``fused_block_wino``, int8 and bf16, second design
   ``conv_block_wino_v2.cu``) at the pool-(2, 2) analog of
   blocks 3 and 4 (a record each) on that request's block-2 output with
   the served blocks 3-4 weights, driven through ``ConvBlock(...,
   wino=True)``, beside the direct9 kernel at pool (2, 2) on the same
   input and bound by the Winograd products' operations (the direct
   conv's beside it); row 4's mel3 and tri tap modes (``mel3=(True,
   True)`` and ``tri=(True, True)`` on their second designs
   ``conv_block_mel3_v2.cu`` and ``conv_block_tri_v2.cu``, int8 at each
   mode's own chunk and the bf16 mode) at the flagship's blocks 3 and 4
   (pool (1, 2), a record each) on that request's block-2 output and then
   the mode's own block-3 output, with the served weights, beside direct9
   on the same input, tri also at its own and direct9's chunk bit for bit
   against the row-4 kernel, mel3 also in its (True, False) mode and in
   bf16 bit for bit against tri, each traced by launch; rows 5-8 and
   both tap modes also against their first designs (int8 bit for bit, the
   first design also against its plain version, bf16 within 1e-2), timed
   in turns with them (v1 v2 v2 v1; mel3 and tri with direct9 between,
   row 5's full block with row 3, row 7 with row 2's all-int8 / bf16
   mode), each design's kernels a call counted
   by the profiler and held to the design's count, beside the cuDNN bf16
   chain (two ``F.conv2d``, or one for row 5 without conv1, affine, ReLU,
   pools) as a yardstick; and the
   log-mel variants v3 (second design ``logmel_v3_v2.cu``, its edge
   frames within 2e-3 dB of the plain frontend's, timed in turns with its
   first design beside row 1, 2 kernels a call by the profiler) and v4
   (second design ``logmel_v4_v2.cu``, timed in turns with its first
   design beside row 1, 2 kernels a call by the profiler) on that
   request's waveform beside row 1's two designs; then rows 3, 4 direct9,
   5 and 6 at M = 4, pool (2, 2), which the second design's GEMM does not
   take: each through its public function bit for bit to its plain version
   in int8, raising its first design's counter once; and row 7 at M = 32
   (its second design) and 48 (its first) on 4 clips of the request's
   block-1 input cut to that many mels, int8 bit for bit and bf16 within
   1e-2 of its plain version, each call raising one counter once.  Each
   design runs once (its launches counted, exactly), then each int8
   kernel is held bit for bit against its plain version and its
   bf16 mode within
   1e-2 relative RMS (v3 within 0.035 dB max and 1e-4 dB mean of its plain
   version, limits that row 1's first design must miss; v4 bit for bit
   against row 1's second design and its first design against row 1's
   first; row 2's int8 records also bit for bit
   against row 2's first design), is timed with CUDA events with its
   weights laid out
   once, as the routes keep them, and each design's relative RMS to the
   f32 plain block (the f64 log-mel) on the same input is reported;
5. train: ``StrongRunner.fit`` on the strong-supervision config's model
   (``configs/strong/biencoder_train.yaml``: BiEncoder(Cnn8Rnn f32,
   EmbeddingAgg(5000, 512), ExpNegL2, shared 512), FrameBceLoss, Adam 1e-3
   with global-norm clipping at 1.0, plateau LR) at full width, batches of
   32 clips x 10 s built in memory in ``AudioPhraseDataset``'s item
   format, 2 epochs of 4 steps with a validation pass each; the GRU
   kernels' counts must rise by one forward and one backward per train
   step and one forward per validation step, the checkpoints must exist,
   the loss must be finite and fall over 8 steps on one fixed batch, and
   every parameter's gradient must lie within a stated relative RMS of
   the all-plain path's on the same batch and weights; then train steps
   are timed with CUDA events and one is profiled.  TF32 is off (full f32
   convolutions and products) for all of it, as the trainer's default;
6. train_bf16: the same fit in the bf16 mixed-precision mode with the
   training kernels opted in (``audio_encoder.args``: ``dtype: bfloat16``,
   ``gru_bwd: bf16``, ``bn_pool: [64, 128]``, ``pool_vjp: [256, 512]``);
   the counts must rise by one log-mel, two of each pool kernel (and of
   ``bn_pool_stats``; ``bn_pool_bwd_three_pass`` none), one bf16
   GRU forward and one bf16 GRU backward per train step, and one log-mel
   and two ``dual_pool_fwd`` per validation step (the bf16 grouped GRU loop
   there, no GRU kernel); checkpoints, a finite loss that falls over 8
   steps on one batch, and gradients within stated relative RMS limits of
   the plain bf16 route's and within twice that route's own change when
   the waveform is scaled by 1 + 1e-6; then three routes are timed (CUDA
   events, 5 steps, in turns a b c c b a) and profiled once each: (a)
   plain bf16 with the f32 GRU kernel, (b) ``bn_pool`` on all four blocks
   + the bf16 GRU, (c) ``pool_vjp`` on all four blocks + the bf16 GRU;
7. train_weak: ``WeakPhraseRunner.fit`` on the phrase-level WSTAG config
   (``configs/weak_phrase/cnn8rnn_w2vmean_similarity.yaml``:
   MultiTextBiEncoder(Cnn8Rnn f32, EmbeddingAgg(5221, 512), DotProduct,
   shared 512, no projections, linear-softmax pooling), ClipBceLoss, Adam
   1e-3 with clipping at 1.0) at full width, batches of 32 clips x 10 s x
   32 phrases from ``AudioSamplePhrasesDataset`` with similarity-sampled
   negatives over data made in memory (noise clips, captions from a
   seeded phrase pool, a random 512-d phrase embedding), 2 epochs of 4
   steps with validation, once with each hoisted GRU backward; the counts
   must rise by one ``gru_fwd`` and one ``gru_bwd_v2`` (or ``_v3``) per
   train step and one ``gru_fwd`` per validation step, checkpoints must
   exist, the loss must fall over 8 steps on one batch and both routes'
   gradients lie within stated relative RMS limits of the all-plain
   path's; then the step is timed with each GRU backward, (a) v1, (b) v2,
   (c) v3, in turns a b c c b a, and profiled once each.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Without a CUDA device, or without the package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}   # H100 SXM, dense
HBM = 3.35e12                                              # bytes / s
SR, CLIP_S = 32000, 10
KERNEL_CLIPS = 32                     # clips in the per-kernel phase
DEVICE = "cuda"


def _cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: dict) -> tuple:
    """(least ms, what bounds it) for ``nbytes`` moved and ``ops`` = {type:
    operation count} at the card's published peaks."""
    t_bytes = nbytes / HBM
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _wbytes(w) -> int:
    """Bytes of a block's weights and BN affines as the wrapper takes them
    (f32)."""
    w1, (a1, b1), w2, (a2, b2) = w
    return 4 * sum(t.numel() for t in (w1, a1, b1, w2, a2, b2))


def _err(got, ref) -> tuple:
    import torch
    d = (got.float() - ref.float()).double()
    rel = torch.sqrt(torch.mean(d ** 2) / torch.mean(ref.double() ** 2))
    return float(d.abs().max()), float(rel)


def kernel_phase(clips: int, rng) -> list:
    """Each kernel against its plain version at the flagship's shapes."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops import frontend

    dev = torch.device(DEVICE)

    def tensor(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def weights(cin, cout):
        he = np.sqrt(2.0 / (9 * cin))
        w1 = tensor(rng.normal(0, he, (3, 3, cin, cout)))
        w2 = tensor(rng.normal(0, np.sqrt(2.0 / (9 * cout)),
                               (3, 3, cout, cout)))
        ab = [(tensor(rng.uniform(0.5, 1.5, cout)),
               tensor(rng.normal(0, 0.1, cout))) for _ in range(2)]
        return w1, ab[0], w2, ab[1]

    n = SR * CLIP_S
    t1 = n // 320 + 1                                 # 1001 frames
    cfg = frontend.cnn8rnn_mel_config(SR)
    rows = []

    # ---- rows 1 (log-mel) and 2 (block 1) in their second designs
    # (csrc/logmel_v2.cu, csrc/conv_block1_v2.cu), held to the plain
    # versions and beside the first designs, timed in turns and traced by
    # launch, with a PyTorch chain as a yardstick
    wave = tensor(rng.normal(0, 0.1, (clips, n)))
    rows.append(_logmel_row(wave, cfg, clips, t1))
    x1 = tensor(rng.normal(0, 1, (clips, t1, 64)), torch.bfloat16)
    rows.append(_block1_row(x1, weights(1, 64), clips, t1))

    # ---- blocks 2-4 in the second design (csrc/conv_block_v2.cu), held
    # bit for bit to the plain version and the first design, timed beside
    # the first in turns and traced by launch, int8 and bf16
    rows += redesigned_rows(clips, rng, tensor, weights, t1 // 2)

    out = []
    for row in rows:
        max_abs, rel = _err(row["got"], row["ref"])
        kind, tol = row["tol"]
        ok = (max_abs if kind != "rel_rms" else rel) <= tol
        if not ok:
            raise AssertionError(f"{row['name']}: kernel disagrees with its "
                                 f"plain version: max_abs {max_abs} "
                                 f"rel_rms {rel} > {kind} {tol}")
        bf16_rel = None
        if "bf16" in row:      # the bf16 mode, off the int8 serving path
            bf16_rel = _err(*row["bf16"]())[1]
            if bf16_rel > 1e-2:
                raise AssertionError(f"{row['name']} (bf16): kernel "
                                     f"disagrees with its plain version: "
                                     f"rel_rms {bf16_rel} > 0.01")
        extra = row["designs"]() if "designs" in row else {}
        kernel_ms = extra.get("ms") or _cuda_ms(row["kernel"], 10)
        plain_ms = _cuda_ms(row["plain"], 3)
        out.append({
            "name": row["name"], "route": "cuda", "source": row["source"],
            "replaces": row["replaces"], "max_abs_err": max_abs,
            "rel_rms_err": rel, "tolerance": f"{kind} <= {tol}",
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": None, "clips": clips,
            "bf16_mode_rel_rms_err": bf16_rel, **extra})
    return out


def _logmel_ops(cfg, frames: int) -> tuple:
    """(DFT, power, mel) operations that the log-mel needs on ``frames``
    frames: the DFT's re and im products over K = n_fft for the bins that
    some mel filter weights, their power, and each mel's products over its
    nonzero filter weights only (``logmel.mel_bands``)."""
    import numpy as np

    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel
    fb = logmel._trimmed_basis(cfg)[2]
    bins = int(np.count_nonzero(fb.any(axis=1)))
    nnz = logmel.mel_bands(fb)[1].size
    return (2.0 * frames * cfg.n_fft * 2 * bins, 3.0 * frames * bins,
            2.0 * frames * nnz)


def _logmel_chain(cfg, device):
    """The log-mel as a PyTorch chain in f32: ``torch.stft`` (cuFFT, the
    reflect-padded Hann frames) → power → ``@`` the slaney filterbank →
    dB; a yardstick that the port never calls."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops import frontend
    win = torch.from_numpy(frontend._padded_window(cfg)).to(
        device, torch.float32)
    fb = torch.from_numpy(frontend.mel_filterbank(cfg)).to(device)

    def chain(wave):
        spec = torch.stft(wave, cfg.n_fft, cfg.hop_length, cfg.win_length,
                          window=win, center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2          # [B, F, T]
        mel = torch.matmul(power.transpose(1, 2), fb)
        return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))
    return chain


def _logmel_row(wave, cfg, clips: int, t1: int) -> dict:
    """Row 1 on its second design, within 2e-3 dB of its plain version;
    both designs timed in turns (v1 v2 v2 v1) and traced by launch, each
    one's gap to the f64 log-mel, and the ``torch.stft`` chain beside."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel

    v2 = lambda: logmel.fused_log_mel_spectrogram(wave, cfg)  # noqa: E731
    v1 = lambda: logmel._fused_log_mel_spectrogram_v1(wave, cfg)  # noqa: E731
    got = v2()
    dft, power, mel = _logmel_ops(cfg, clips * t1)
    ops = {"bf16": dft, "f32": power + mel}
    chain = _logmel_chain(cfg, wave.device)

    def designs():
        f64 = _log_mel_f64(wave, cfg)
        first = v1()
        turns = _turns({"v1": v1, "v2": v2})
        return {"ms": turns["v2"], "v1_ms": turns["v1"],
                "turns_ms": turns["runs"],
                "v1_max_abs_err": _err(got, first)[0],
                "max_abs_vs_f64": _err(got, f64)[0],
                "v1_max_abs_vs_f64": _err(first, f64)[0],
                "chain_ms": _cuda_ms(lambda: chain(wave), 10),
                "chain_max_abs_vs_f64": _err(chain(wave), f64)[0],
                "chain": "torch.stft (cuFFT) -> power -> @ fb -> dB, f32",
                "v1_source": "texttoaudiogrounding_tpu_torch/csrc/logmel.cu",
                "v2_trace": _trace(v2, turns["v2"], by_launch=True),
                "v1_trace": _trace(v1, turns["v1"], by_launch=True)}

    return dict(
        name="logmel",
        source="texttoaudiogrounding_tpu_torch/csrc/logmel_v2.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/logmel.py:438",
        got=got, ref=logmel.log_mel_plain(wave, cfg),
        tol=("max_abs_db", 2e-3), kernel=v2,
        plain=lambda: logmel.log_mel_plain(wave, cfg), designs=designs,
        bound=_bound(wave.numel() * 4 + got.numel() * 4, ops))


def _block1_chain(w):
    """Block 1's bf16 mode as a PyTorch chain: cuDNN bf16 ``F.conv2d``,
    the BN affine and ReLU, again, then ``avg_pool2d + max_pool2d``; a
    yardstick that the port never calls."""
    import torch
    import torch.nn.functional as F
    w1, (a1, b1), w2, (a2, b2) = w
    k1 = w1.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    k2 = w2.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    aff = [(a.to(torch.bfloat16)[:, None, None], b.to(torch.bfloat16)[
        :, None, None]) for a, b in ((a1, b1), (a2, b2))]

    def chain(x):
        y = F.conv2d(x[:, None], k1, padding=1)
        y = torch.relu(y * aff[0][0] + aff[0][1])
        y = F.conv2d(y, k2, padding=1)
        y = torch.relu(y * aff[1][0] + aff[1][1])
        return F.avg_pool2d(y, 2) + F.max_pool2d(y, 2)
    return chain


def _block1_row(x1, w, clips: int, t1: int) -> dict:
    """Row 2 on its second design in the served ``"conv1"`` mode (within
    1e-2 relative RMS of its plain version, the gap to the first design
    reported), ``False`` likewise, ``True`` and ``single`` bit for bit to
    the plain version and the first design; both designs timed in turns in
    every mode with the weights laid out once, traced by launch in
    ``"conv1"`` and ``True``, and the cuDNN bf16 chain beside."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair

    modes = {"conv1": ("conv1", "triple"), "bf16": (False, "triple"),
             "int8": (True, "triple"), "single": (True, "single")}
    prep = {q: conv_block1_pair.kernel_weights(*w, q)
            for q in ("conv1", False, True)}

    def fn(design, key):
        q, mode = modes[key]
        run = (conv_block1_pair.fused_block1_pair if design == "v2"
               else conv_block1_pair._fused_block1_pair_v1)
        return lambda: run(x1, *w, quantize=q, mode=mode, prepared=prep[q])

    got = fn("v2", "conv1")()
    ops = {"int8": 2.0 * clips * t1 * 64 * 9 * 64,
           "bf16": 2.0 * clips * (t1 // 2 * 2) * 64 * 576 * 64}
    chain = _block1_chain(w)

    def designs():
        out = {}
        for key, (q, mode) in modes.items():
            g2, g1 = fn("v2", key)(), fn("v1", key)()
            plain = conv_block1_pair.block1_plain(x1, *w, quantize=q,
                                                  mode=mode)
            if q is True and (_err(g2, plain)[0] or _err(g2, g1)[0]):
                raise AssertionError(f"conv_block1_pair {key}: the second "
                                     f"design differs from the plain "
                                     f"version or the first: "
                                     f"{_err(g2, plain)}, {_err(g2, g1)}")
            rel = _err(g2, plain)[1]
            if rel > 1e-2:
                raise AssertionError(f"conv_block1_pair {key}: rel_rms "
                                     f"{rel} to its plain version > 0.01")
            turns = _turns({"v1": fn("v1", key), "v2": fn("v2", key)})
            out[key] = {"ms": turns["v2"], "v1_ms": turns["v1"],
                        "turns_ms": turns["runs"],
                        "max_abs_err": _err(g2, plain)[0],
                        "rel_rms_err": rel,
                        "v1_max_abs_err": _err(g2, g1)[0],
                        "v1_rel_rms_err": _err(g2, g1)[1]}
            if key in ("conv1", "int8"):
                for d in ("v2", "v1"):
                    out[key][f"{d}_trace"] = _trace(fn(d, key), turns[d],
                                                    by_launch=True)
        c16 = chain(x1)
        return {"ms": out["conv1"]["ms"], "v1_ms": out["conv1"]["v1_ms"],
                "modes": out,
                "chain_ms": _cuda_ms(lambda: chain(x1), 10),
                "chain_rel_rms_vs_bf16_plain": _err(
                    c16.permute(0, 2, 3, 1), conv_block1_pair.block1_plain(
                        x1, *w, quantize=False))[1],
                "chain": "cuDNN bf16 F.conv2d -> affine -> ReLU, twice -> "
                         "avg_pool2d + max_pool2d",
                "v1_source": "texttoaudiogrounding_tpu_torch/csrc/"
                             "conv_block1_pair.cu"}

    return dict(
        name="conv_block1_pair",
        source="texttoaudiogrounding_tpu_torch/csrc/conv_block1_v2.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/conv_block1_pair.py:346",
        got=got, ref=conv_block1_pair.block1_plain(x1, *w, quantize="conv1"),
        tol=("rel_rms", 1e-2), kernel=fn("v2", "conv1"),
        plain=lambda: conv_block1_pair.block1_plain(x1, *w),
        bf16=lambda: (fn("v2", "bf16")(), conv_block1_pair.block1_plain(
            x1, *w, quantize=False)),
        designs=designs,
        bound=_bound(x1.numel() * 2 + got.numel() * 2 + _wbytes(w), ops))


def _turns(fns: dict, order=("v1", "v2")) -> dict:
    """ms per call of designs {"v1": fn, "v2": fn, ...} timed in turns
    (order, then order reversed: v1 v2 v2 v1; 10 calls each): the mean of
    each design's two runs and all of them."""
    runs = [(k, _cuda_ms(fns[k], 10)) for k in order + order[::-1]]
    return {k: sum(ms for n, ms in runs if n == k) / 2 for k in fns} | {
        "runs": runs}


def redesigned_rows(clips: int, rng, tensor, weights, t2: int) -> list:
    """Rows 3 (block 2) and 4 (blocks 3 and 4) at the served shapes, on the
    second design: int8 held to the plain version and to the first design
    with max |d| = 0, bf16 to the plain version within 1e-2 relative RMS;
    both designs timed in turns (v1 v2 v2 v1) in int8 and bf16 and traced
    by launch, each with its weights laid out once, as the model keeps
    them."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        conv_block, conv_block_pair)

    def block(x, w, pool, pair):
        # (v2, v1, plain, tc) for int8 (q True) and bf16
        out = {}
        for q in (True, False):
            wk = conv_block.kernel_weights(*w, q)
            if pair:
                tc = conv_block_pair.pick_tc_pair(x.shape[1],
                                                  x.shape[2] // 2,
                                                  wk[0].shape[0], q)
                out[q] = (lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block_pair.fused_block2_pair(
                              x, *w, quantize=q, tc=tc, prepared=wk),
                          lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block_pair._launch_v1(x, wk, q, tc),
                          lambda x=x, q=q, tc=tc:
                          conv_block_pair.block2_plain(x, *w, quantize=q,
                                                       tc=tc), tc)
            else:
                tc = conv_block.pick_tc(x.shape[1], x.shape[2], x.shape[3],
                                        wk[0].shape[0], *pool, q)
                out[q] = (lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block.fused_double_conv_pool(
                              x, *w, pool, quantize=q, tc=tc, prepared=wk),
                          lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block._fused_double_conv_pool_v1(
                              x, *w, pool, quantize=q, tc=tc, prepared=wk),
                          lambda x=x, q=q, tc=tc:
                          conv_block.double_conv_plain(
                              x, *w, pool, quantize=q, tc=tc), tc)
        return out

    # block 2: [B, 500, 32, 64] -> [B, 250, 16, 128]
    x2 = tensor(np.abs(rng.normal(0, 1, (clips, t2, 32, 64))),
                torch.bfloat16)
    w2 = weights(64, 128)
    pos = clips * t2 * 32
    specs = [("conv_block_pair", "conv_block_pair.py:211", [
        (x2, w2, (2, 2), True,
         {"int8": 2.0 * pos * 576 * 128 + 2.0 * pos * 1152 * 128})])]
    # blocks 3 and 4: one kernel, two launches per forward
    t3, parts = t2 // 2, []
    for m, cin, cout in ((16, 128, 256), (8, 256, 512)):
        x = tensor(np.abs(rng.normal(0, 1, (clips, t3, m, cin))),
                   torch.bfloat16)
        pos = clips * t3 * m
        parts.append((x, weights(cin, cout), (1, 2), False,
                      {"int8": 2.0 * pos * 9 * (cin * cout + cout * cout)}))
    specs.append(("conv_block", "conv_block.py:370", parts))

    rows = []
    for name, replaces, blocks in specs:
        fns = [block(*b[:4]) for b in blocks]

        def each(q, k, fns=fns):
            return lambda: [f[q][k]() for f in fns]

        got = [f[True][0]() for f in fns]
        ref = [f[True][2]() for f in fns]
        v1 = [f[True][1]() for f in fns]
        vs_v1 = max(_err(g, r)[0] for g, r in zip(got, v1))
        if vs_v1 != 0.0:
            raise AssertionError(f"{name}: the second design differs from "
                                 f"the first: max_abs {vs_v1}")
        bound = [_bound(b[0].numel() * 2 + g.numel() * 2 + _wbytes(b[1]),
                        b[4]) for b, g in zip(blocks, got)]

        def both_designs(fns=fns, name=name, vs_v1=vs_v1):
            t8 = _turns({"v1": each(True, 1, fns), "v2": each(True, 0, fns)})
            t16 = _turns({"v1": each(False, 1, fns),
                          "v2": each(False, 0, fns)})
            g16 = [f[False][0]() for f in fns]
            r16 = [f[False][1]() for f in fns]
            traces = {f"{d}_{k}_trace": _trace(each(q, i, fns), tm[d],
                                                by_launch=True)
                      for q, k, tm in ((True, "int8", t8),
                                       (False, "bf16", t16))
                      for d, i in (("v2", 0), ("v1", 1))}
            return {"ms": t8["v2"], "v1_ms": t8["v1"], "turns_ms": t8["runs"],
                    "bf16_ms": t16["v2"], "v1_bf16_ms": t16["v1"],
                    "bf16_turns_ms": t16["runs"],
                    "v1_max_abs_err": vs_v1,
                    "bf16_v1_rel_rms": max(_err(g, r)[1]
                                           for g, r in zip(g16, r16)),
                    "tc": [f[True][3] for f in fns],
                    "bf16_tc": [f[False][3] for f in fns],
                    "v1_source": "texttoaudiogrounding_tpu_torch/csrc/"
                                 + ("conv_block_pair.cu"
                                    if name == "conv_block_pair"
                                    else "conv_block.cu"),
                    **traces}

        rows.append(dict(
            name=name,
            source="texttoaudiogrounding_tpu_torch/csrc/conv_block_v2.cu",
            replaces=f"texttoaudiogrounding_tpu/ops/pallas/{replaces}",
            got=torch.cat([g.reshape(-1) for g in got]),
            ref=torch.cat([r.reshape(-1) for r in ref]),
            tol=("max_abs", 0.0), kernel=each(True, 0), plain=each(True, 2),
            bf16=lambda fns=fns: (
                torch.cat([f[False][0]().reshape(-1) for f in fns]),
                torch.cat([f[False][2]().reshape(-1) for f in fns])),
            designs=both_designs,
            bound=(sum(b[0] for b in bound), bound[-1][1])))
    return rows


GRU_T, GRU_H, GRU_IN = 250, 256, 512     # the BiGRU at the main path's shapes
# The bf16-operand backward against its plain version, by relative RMS of
# each gradient (dproj, dwh, dbn), on an H100 80GB HBM3 at 700 W: at most
# 8.8e-4 at T = 250, where a dcol summed in another f32 order rounds to
# the other bf16 neighbour and the walk carries it on, and the f32
# backward lies about as far off (1e-3).  So the bf16 roundings are held
# at T = 2: there one such flip reads 2.5e-6 / 1.6e-5 / 2.4e-6, and the
# same backward without its roundings of h_{t-1} and dcol (the f32
# backward given the bf16-rounded Wh) 3.7e-4 / 2.4e-3 / 3.6e-4, which
# must miss the tolerance by GRU_B16_MISS times in the same run.
GRU_B16_TOL, GRU_B16_SHORT_TOL, GRU_B16_MISS = 2e-3, (2e-5, 1e-4, 2e-5), 10


def _max_err(got, ref) -> tuple:
    """(max abs, max relative RMS) over the tensors of ``got``."""
    import torch
    if isinstance(got, torch.Tensor):
        return _err(got, ref)
    errs = [_err(a, b) for a, b in zip(got, ref)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _gru_bf16_short(proj, gy, wh, bn) -> dict:
    """The bf16-operand backward at T = 2 (the first two steps of the main
    path's inputs), per gradient against its plain version, beside the
    unrounded backward's gap, which must be GRU_B16_MISS times the
    tolerance."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    b16 = torch.bfloat16
    proj2, gy2 = proj[:2].contiguous(), gy[:2].contiguous()
    ys2 = gru.gru_forward_plain(proj2, wh, bn, b16)
    ref = gru.gru_backward_plain(proj2, ys2, gy2, wh, bn, b16)
    got = gru.gru_backward(proj2, ys2, gy2, wh, bn, b16)
    unrounded = gru.gru_backward(proj2, ys2, gy2, wh.to(b16).float(), bn)
    rel = [_err(a, r)[1] for a, r in zip(got, ref)]
    miss = [_err(a, r)[1] for a, r in zip(unrounded, ref)]
    if any(e > tol or m < GRU_B16_MISS * tol
           for e, m, tol in zip(rel, miss, GRU_B16_SHORT_TOL)):
        raise AssertionError(
            f"gru_bwd_bf16 at T = 2: rel_rms (dproj, dwh, dbn) {rel} "
            f"(limits {GRU_B16_SHORT_TOL}); without the bf16 roundings "
            f"{miss} (must reach {GRU_B16_MISS} times the limits)")
    return {"T": 2, "rel_rms_err": rel, "tolerance": GRU_B16_SHORT_TOL,
            "unrounded_rel_rms": miss}


# the cluster design's plan that cluster_plan does not take: groups of 8
# rows (2 x 4 clusters at B = 32, more than the 7 of 16 CTAs an H100 holds
# at once), timed beside the plan it takes
GRU_ROWS_ALT = 8


def _gru_cluster_rows(proj, ys, gy, wh, bn, dtype, rows: int):
    """A call of the cluster backward with groups of ``rows`` rows, in
    place of ``cluster_plan``'s, through its C entry point."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import _build, gru

    t, b2, h = ys.shape
    plan = gru.cluster_plan(b2 // 2, h, dtype)
    groups = -(-(b2 // 2) // rows)
    b16 = dtype == torch.bfloat16
    whk = wh.to(dtype).float() if b16 else wh
    n = 2 * h * 3 * h + 2 * h
    dproj = torch.empty_like(proj)
    out = torch.empty(n, device=proj.device)
    part = torch.empty(groups, n, device=proj.device)
    fn = _build.function("gru_bwd_sm90", "ttg_gru_bwd_cluster",
                         [_build.P] * 8 + [_build.I] * 7 + [_build.P])

    def call():
        _build.check(fn(proj.data_ptr(), ys.data_ptr(), gy.data_ptr(),
                        whk.data_ptr(), bn.data_ptr(), dproj.data_ptr(),
                        out.data_ptr(), part.data_ptr(), t, b2 // 2, h,
                        plan["ctas"], groups, rows, int(b16),
                        _build.stream()), "ttg_gru_bwd_cluster")
        return (dproj, out[:n - 2 * h].view(2, h, 3 * h),
                out[n - 2 * h:].view(2, h))
    return call, groups


def _launches_per_call(fn) -> int:
    """The CUDA launches of one traced call of ``fn``, of any kernel,
    counted by the profiler."""
    return _trace(fn, 1.0, by_launch=True)["launches"]


def _gru_designs(proj, ys, gy, wh, bn, dtype, tiny) -> dict:
    """The backward's two designs at the main path's inputs: the first
    design's gradients and those of the cluster design with groups of
    GRU_ROWS_ALT rows (to hold the chosen plan to), the three timed in
    turns (per_step, cluster, rows_alt, rows_alt, cluster, per_step; 10
    calls each), each design's latency floor (the same walk at B = 1, H =
    4: ``tiny`` = (proj, ys, gy, wh, bn)), the cluster plan and how many
    of its clusters the card holds at once, and each design's CUDA
    launches a call."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def call(design, args=(proj, ys, gy, wh, bn)):
        return lambda: gru.gru_backward(*args, dtype, design=design)

    alt, alt_groups = _gru_cluster_rows(proj, ys, gy, wh, bn, dtype,
                                        GRU_ROWS_ALT)
    fns = {"per_step": call("per_step"), "cluster": call("cluster"),
           "rows_alt": alt}
    order = ("per_step", "cluster", "rows_alt")
    runs = [(d, _cuda_ms(fns[d], 10)) for d in order + order[::-1]]
    t, b2, h = ys.shape
    plan = gru.cluster_plan(b2 // 2, h, dtype)
    return {"per_step": call("per_step")(), "rows_alt_grads": alt(),
            "ms": {d: sum(ms for n, ms in runs if n == d) / 2
                   for d in order},
            "turns_ms": runs,
            "launches_per_call": {d: _launches_per_call(call(d))
                                  for d in gru.DESIGNS},
            "floor_ms": {d: _cuda_ms(call(d, tiny), 10)
                         for d in gru.DESIGNS},
            "plan": plan,
            "co_resident_clusters": gru.cluster_occupancy(h, plan, dtype),
            "clusters": 2 * plan["groups"],
            "rows_alt": {"rows": GRU_ROWS_ALT, "clusters": 2 * alt_groups}}


# batch rows a direction at which the forward's two designs are also held
# to their plain versions, to each other and to torch.nn.GRU: a ragged B
# whose groups differ in size, and the bench's B = 128, which runs the
# cluster design in waves
GRU_FWD_EXTRA_B = (13, 128)


def _gru_fwd_designs(proj, wh, bn, dtype, tiny) -> dict:
    """The forward's two designs at the main path's inputs: the first
    design's outputs, both timed in turns (per_step, cluster, cluster,
    per_step; 10 calls each), each design's latency floor (the same walk
    at B = 1, H = 4: ``tiny`` = (proj, wh, bn)), the cluster design's
    exchange floor (B = 1 at the main path's H, where 16 CTAs exchange
    their slices of h_t each step around almost no arithmetic), the
    cluster plan and how many of its clusters the card holds at once, and
    each design's CUDA launches a call."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def call(design, args=(proj, wh, bn)):
        return lambda: gru.gru_forward(*args, dtype, design=design)

    order = ("per_step", "cluster")
    runs = [(d, _cuda_ms(call(d), 10)) for d in order + order[::-1]]
    t, b2, h3 = proj.shape
    plan = gru.forward_plan(b2 // 2, h3 // 3, dtype)
    one_row = (proj[:, ::b2 // 2].contiguous(), wh, bn)      # row 0 of each
    return {"per_step": call("per_step")(),
            "exchange_floor_ms": _cuda_ms(call("cluster", one_row), 10),
            "ms": {d: sum(ms for n, ms in runs if n == d) / 2
                   for d in order},
            "turns_ms": runs,
            "launches_per_call": {d: _launches_per_call(call(d))
                                  for d in gru.DESIGNS},
            "floor_ms": {d: _cuda_ms(call(d, tiny), 10)
                         for d in gru.DESIGNS},
            "plan": plan,
            "co_resident_clusters": gru.cluster_occupancy(
                h3 // 3, plan, dtype, forward=True),
            "clusters": 2 * plan["groups"]}


# The forward's first GRU_FWD_SHORT_T steps, where a sum in another order
# moves ys by about 5e-8: both carries are held to GRU_FWD_SHORT_TOL of
# their plain versions, and the f32 carry (on Wh rounded to bf16, and on
# Wh as it is) must miss the bf16 carry's plain version by
# GRU_FWD_B16_MISS times that limit in the same run, so that a bf16
# forward that rounds no carry fails.  Also at shapes with an odd number
# of units a CTA (GRU_FWD_ODD, B = 5 at H = 30 and 120: 2 and 8 CTAs of
# 15), where the bf16 carry's mma.sync epilogue holds a lone last column.
GRU_FWD_SHORT_T, GRU_FWD_SHORT_TOL, GRU_FWD_B16_MISS = 2, 1e-5, 10
GRU_FWD_ODD = ((5, 30), (5, 120))


def _gru_fwd_short(proj, wh, bn) -> dict:
    """The forward of both carries at the first GRU_FWD_SHORT_T steps of
    ``proj`` against their plain versions, beside the f32 carry's gap to
    the bf16 carry's plain version."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    b16 = torch.bfloat16
    p = proj[:GRU_FWD_SHORT_T].contiguous()
    ref16 = gru.gru_forward_plain(p, wh, bn, b16)
    rel = {"f32": _err(gru.gru_forward(p, wh, bn),
                       gru.gru_forward_plain(p, wh, bn))[1],
           "bf16": _err(gru.gru_forward(p, wh, bn, b16), ref16)[1]}
    miss = {"f32_carry_bf16_wh": _err(gru.gru_forward(
                p, wh.to(b16).float(), bn), ref16)[1],
            "f32_carry": _err(gru.gru_forward(p, wh, bn), ref16)[1]}
    if (max(rel.values()) > GRU_FWD_SHORT_TOL
            or min(miss.values()) < GRU_FWD_B16_MISS * GRU_FWD_SHORT_TOL):
        raise AssertionError(
            f"gru_fwd at T = {GRU_FWD_SHORT_T}, rows {proj.shape[1]}, H = "
            f"{wh.shape[1]}: rel_rms {rel} (limit {GRU_FWD_SHORT_TOL}); the "
            f"f32 carry off the bf16 carry's plain version by {miss} (must "
            f"reach {GRU_FWD_B16_MISS} times the limit)")
    return {"T": GRU_FWD_SHORT_T, "rel_rms_err": rel,
            "tolerance": GRU_FWD_SHORT_TOL,
            "f32_carry_rel_rms_vs_bf16_plain": miss}


def _gru_fwd_odd(b: int, h: int, rng) -> dict:
    """The cluster forward at ``b`` rows a direction of ``h`` units, an
    odd number a CTA: each carry against its plain version over GRU_T
    steps (1e-4 / 1e-2) and over the first GRU_FWD_SHORT_T."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def tensor(shape, std):
        return torch.from_numpy(rng.normal(0, std, shape).astype(
            np.float32)).to(DEVICE)

    proj = tensor((GRU_T, 2 * b, 3 * h), 1.0)
    wh = tensor((2, h, 3 * h), 1 / np.sqrt(h))
    bn = tensor((2, h), 0.05)
    plan = gru.forward_plan(b, h)
    if plan["units"] % 2 == 0:
        raise AssertionError(f"GRU_FWD_ODD: B = {b}, H = {h} gives "
                             f"{plan['units']} units a CTA, not odd")
    out = {"B": b, "H": h, "plan": plan,
           "short_T": _gru_fwd_short(proj, wh, bn)}
    for dtype, key, tol in ((torch.float32, "gru_fwd", 1e-4),
                            (torch.bfloat16, "gru_fwd_bf16", 1e-2)):
        err = _err(gru.gru_forward(proj, wh, bn, dtype),
                   gru.gru_forward_plain(proj, wh, bn, dtype))
        if err[1] > tol:
            raise AssertionError(f"{key} at B = {b}, H = {h}: rel_rms "
                                 f"{err[1]} > {tol}")
        out[key] = {"rel_rms_err": err[1], "max_abs_err": err[0]}
    return out


def _gru_fwd_extra(project, lib, as_batch_first, wh, bn, b: int,
                   rng) -> dict:
    """Both forward designs at ``b`` rows a direction, each carry against
    its plain version (1e-4 / 1e-2) and the first design, the f32 carry also
    against ``torch.nn.GRU`` (1e-3 max abs), with each design's ms."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    x = torch.from_numpy(rng.normal(0, 1, (b, GRU_T, GRU_IN)).astype(
        "float32")).to(wh.device)
    proj = project(x)
    with torch.no_grad():
        lib_out, _ = lib(x)
    out = {"B": b}
    for dtype, key, tol in ((torch.float32, "gru_fwd", 1e-4),
                            (torch.bfloat16, "gru_fwd_bf16", 1e-2)):
        ys = gru.gru_forward(proj, wh, bn, dtype)
        first = gru.gru_forward(proj, wh, bn, dtype, design="per_step")
        errs = [_err(ys, gru.gru_forward_plain(proj, wh, bn, dtype)),
                _err(ys, first),
                _err(first, gru.gru_forward_plain(proj, wh, bn, dtype))]
        if max(e[1] for e in errs) > tol:
            raise AssertionError(
                f"{key} at B = {b}: rel_rms (cluster vs plain, vs first "
                f"design, first vs plain) {[e[1] for e in errs]} > {tol}")
        rec = {"rel_rms_err": errs[0][1], "max_abs_err": errs[0][0],
               "vs_per_step_rel_rms": errs[1][1],
               "plan": gru.forward_plan(b, GRU_H, dtype),
               "ms": _cuda_ms(lambda: gru.gru_forward(proj, wh, bn, dtype),
                              10),
               "per_step_ms": _cuda_ms(lambda: gru.gru_forward(
                   proj, wh, bn, dtype, design="per_step"), 10)}
        if dtype == torch.float32:
            gap = float((as_batch_first(ys, b) - lib_out).abs().max())
            if gap > 1e-3:
                raise AssertionError(f"{key} at B = {b}: off torch.nn.GRU "
                                     f"by {gap}")
            rec["library_max_abs_diff"] = gap
        out[key] = rec
    return out


# The hoisted walks (row 16) are also held to their plain versions at a
# ragged B, at odd units a CTA and over their first GRU_WALK_SHORT_T steps
# (where another order of summation moves them by about 1e-7)
GRU_WALK_SHAPES = ((13, 256), (5, 30), (5, 120))
GRU_WALK_SHORT_T, GRU_WALK_SHORT_TOL = 2, 1e-5


def _gru_walk_designs(proj, ys, gy, wh, bn, variant, tiny) -> dict:
    """The hoisted walk ``variant``'s two designs at the main path's
    inputs: the outputs of both and of the plain walk, both timed in turns
    (per_step, cluster, cluster, per_step; 10 calls each) and the dWh
    product after the walk apart, the whole backward of each design, each
    design's latency floor (the walk at B = 1, H = 4: ``tiny`` = (proj,
    ys, gy, wh, bn)), the cluster walk's exchange floor (B = 1 at the main
    path's H), the plan and how many of its clusters the card holds at
    once, and each design's CUDA launches a walk."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def call(design, args=(proj, ys, gy, wh, bn)):
        return lambda: gru.gru_walk(*args, variant, design)

    order = ("per_step", "cluster")
    runs = [(d, _cuda_ms(call(d), 10)) for d in order + order[::-1]]
    got = call("cluster")()
    t, b2, h = ys.shape
    plan = gru.walk_plan(b2 // 2, h)
    one_row = tuple(x[:, ::b2 // 2].contiguous() for x in (proj, ys, gy))
    launches = {d: _launches_per_call(call(d)) for d in gru.DESIGNS}
    if launches["cluster"] != 1:
        raise AssertionError(f"gru_bwd_{variant}: the cluster walk made "
                             f"{launches['cluster']} CUDA launches, not 1")
    return {"got": got, "per_step": call("per_step")(),
            "plain": gru.gru_walk_plain(proj, ys, gy, wh, bn,
                                        variant == "v3"),
            "ms": {d: sum(ms for n, ms in runs if n == d) / 2
                   for d in order},
            "turns_ms": runs,
            "dwh_product_ms": _cuda_ms(
                lambda: gru.hoisted_weight_grads(ys, *got), 10),
            "whole_ms": {d: _cuda_ms(lambda d=d: gru.gru_backward_hoisted(
                proj, ys, gy, wh, bn, variant, d), 10) for d in gru.DESIGNS},
            "floor_ms": {d: _cuda_ms(call(d, tiny), 10) for d in gru.DESIGNS},
            "exchange_floor_ms": _cuda_ms(call("cluster", one_row + (wh, bn)),
                                          10),
            "launches_per_call": launches, "plan": plan,
            "co_resident_clusters": gru.cluster_occupancy(
                h, plan, torch.float32, variant=variant),
            "clusters": 2 * plan["groups"]}


def _gru_walk_short(proj, ys, gy, wh, bn, variant) -> dict:
    """The cluster walk over the first GRU_WALK_SHORT_T steps of its inputs
    against the plain walk, within GRU_WALK_SHORT_TOL."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    args = tuple(x[:GRU_WALK_SHORT_T].contiguous() for x in (proj, ys, gy))
    err = _max_err(gru.gru_walk(*args, wh, bn, variant),
                   gru.gru_walk_plain(*args, wh, bn, variant == "v3"))
    if err[1] > GRU_WALK_SHORT_TOL:
        raise AssertionError(
            f"gru_bwd_{variant} walk at T = {GRU_WALK_SHORT_T}, rows "
            f"{proj.shape[1]}, H = {wh.shape[1]}: rel_rms {err[1]} > "
            f"{GRU_WALK_SHORT_TOL}")
    return {"T": GRU_WALK_SHORT_T, "rel_rms_err": err[1],
            "max_abs_err": err[0], "tolerance": GRU_WALK_SHORT_TOL}


def _gru_walk_shapes(rng) -> list:
    """Both hoisted walks at GRU_WALK_SHAPES (B, H) over GRU_T steps
    against their plain versions (1e-4) and, where H suits it, their first
    design, and over the first GRU_WALK_SHORT_T steps (1e-5)."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def tensor(shape, std):
        return torch.from_numpy(rng.normal(0, std, shape).astype(
            np.float32)).to(DEVICE)

    out = []
    for b, h in GRU_WALK_SHAPES:
        proj = tensor((GRU_T, 2 * b, 3 * h), 1.0)
        wh = tensor((2, h, 3 * h), 1 / np.sqrt(h))
        bn = tensor((2, h), 0.05)
        gy = tensor((GRU_T, 2 * b, h), 1.0)
        ys = gru.gru_forward_plain(proj, wh, bn)
        rec = {"B": b, "H": h, "plan": gru.walk_plan(b, h)}
        for v in gru.VARIANTS:
            got = gru.gru_walk(proj, ys, gy, wh, bn, v)
            errs = {"plain": _max_err(got, gru.gru_walk_plain(
                proj, ys, gy, wh, bn, v == "v3"))}
            if h % 4 == 0:                   # the first design's JT = 4
                errs["per_step"] = _max_err(got, gru.gru_walk(
                    proj, ys, gy, wh, bn, v, "per_step"))
            if max(e[1] for e in errs.values()) > 1e-4:
                raise AssertionError(f"gru_bwd_{v} walk at B = {b}, H = {h}: "
                                     f"rel_rms {errs} > 1e-4")
            rec[v] = {"rel_rms_err": errs["plain"][1],
                      "max_abs_err": errs["plain"][0],
                      "vs_per_step_rel_rms": errs.get("per_step",
                                                      (None, None))[1],
                      "short_T": _gru_walk_short(proj, ys, gy, wh, bn, v)}
        out.append(rec)
    return out


def gru_kernel_phase(clips: int, rng) -> list:
    """The GRU kernels against their plain versions at T = 250, 2B = 64,
    H = 256, beside ``torch.nn.GRU`` on the same weights; the backward's
    second design also against its first."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    dev = torch.device(DEVICE)
    t, b, h, d = GRU_T, clips, GRU_H, GRU_IN

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = tensor(rng.normal(0, 1, (b, t, d)))
    x_rng = np.random.default_rng(1)          # the extra batch sizes' inputs
    w_ih = tensor(rng.normal(0, 1 / np.sqrt(d), (2, 3 * h, d)))
    w_hh = tensor(rng.normal(0, 1 / np.sqrt(h), (2, 3 * h, h)))
    b_ih = tensor(rng.normal(0, 0.05, (2, 3 * h)))
    b_hh = tensor(rng.normal(0, 0.05, (2, 3 * h)))
    gy = tensor(rng.normal(0, 1, (t, 2 * b, h)))
    # the port's layout (models/layers.py BiGRU): time-major, direction 1
    # time-flipped, the r/z recurrent biases folded into the input ones
    bi = b_ih + torch.cat([b_hh[:, :2 * h], torch.zeros_like(b_hh[:, :h])],
                          dim=1)

    def project(x):
        xg = torch.stack([x, torch.flip(x, dims=(1,))])
        return (torch.matmul(xg, w_ih.transpose(1, 2)[:, None])
                + bi[:, None, None]).permute(2, 0, 1, 3).reshape(
                    t, 2 * x.shape[0], 3 * h).contiguous()

    proj = project(x)
    wh = w_hh.transpose(1, 2).contiguous()
    bn = b_hh[:, 2 * h:].contiguous()

    lib = torch.nn.GRU(d, h, bidirectional=True, batch_first=True).to(dev)
    with torch.no_grad():
        for i, sfx in enumerate(("", "_reverse")):
            getattr(lib, f"weight_ih_l0{sfx}").copy_(w_ih[i])
            getattr(lib, f"weight_hh_l0{sfx}").copy_(w_hh[i])
            getattr(lib, f"bias_ih_l0{sfx}").copy_(b_ih[i])
            getattr(lib, f"bias_hh_l0{sfx}").copy_(b_hh[i])
    lib16 = torch.nn.GRU(d, h, bidirectional=True, batch_first=True).to(
        dev, torch.bfloat16)
    lib16.load_state_dict(lib.state_dict())
    lib.flatten_parameters()
    lib16.flatten_parameters()
    x16 = x.to(torch.bfloat16)
    gy_lib = torch.randn(b, t, 2 * h, device=dev)

    def lib_fwd_bwd():
        out, _ = lib(x)
        out.backward(gy_lib)

    def as_batch_first(ys, rows=b):
        ys = ys.reshape(t, 2, rows, h).permute(1, 2, 0, 3)
        return torch.cat([ys[0], torch.flip(ys[1], dims=(1,))], dim=-1)

    ys = gru.gru_forward(proj, wh, bn)
    ys_plain = gru.gru_forward_plain(proj, wh, bn)
    with torch.no_grad():
        lib_out, _ = lib(x)
    lib_gap = float((as_batch_first(ys) - lib_out).abs().max())
    if lib_gap > 1e-3:
        raise AssertionError(f"gru_fwd: off torch.nn.GRU by {lib_gap}")
    ys16 = gru.gru_forward(proj, wh, bn, torch.bfloat16)
    ys16_plain = gru.gru_forward_plain(proj, wh, bn, torch.bfloat16)
    grads = gru.gru_backward(proj, ys_plain, gy, wh, bn)
    grads_plain = gru.gru_backward_plain(proj, ys_plain, gy, wh, bn)
    b16 = torch.bfloat16
    grads16 = gru.gru_backward(proj, ys16_plain, gy, wh, bn, b16)
    grads16_plain = gru.gru_backward_plain(proj, ys16_plain, gy, wh, bn, b16)
    short = _gru_bf16_short(proj, gy, wh, bn)
    hoisted = {v: gru.gru_backward_hoisted(proj, ys_plain, gy, wh, bn, v)
               for v in gru.VARIANTS}
    hoisted_plain = {v: gru.gru_backward_hoisted_plain(
        proj, ys_plain, gy, wh, bn, v == "v3") for v in gru.VARIANTS}

    # the per-step launch floor: the same walks at B = 1, H = 4
    tiny = (torch.zeros(t, 2, 12, device=dev), torch.zeros(2, 4, 12,
                                                           device=dev),
            torch.zeros(2, 4, device=dev))
    tiny_ys = gru.gru_forward(*tiny)
    tiny_bwd = (tiny[0], tiny_ys, torch.zeros_like(tiny_ys), *tiny[1:])
    # the forward's two designs, f32 and bf16 carry; then both at the
    # extra batch sizes
    fwd_designs = {"gru_fwd": _gru_fwd_designs(proj, wh, bn, torch.float32,
                                               tiny),
                   "gru_fwd_bf16": _gru_fwd_designs(proj, wh, bn,
                                                    torch.bfloat16, tiny)}
    fwd_extra = [_gru_fwd_extra(project, lib, as_batch_first, wh, bn, eb,
                                x_rng) for eb in GRU_FWD_EXTRA_B]
    fwd_short = _gru_fwd_short(proj, wh, bn)
    fwd_odd = [_gru_fwd_odd(ob, oh, x_rng) for ob, oh in GRU_FWD_ODD]
    # the hoisted walks' two designs, at the main path's inputs, then at
    # the extra shapes
    walk_designs = {v: _gru_walk_designs(proj, ys_plain, gy, wh, bn, v,
                                         tiny_bwd) for v in gru.VARIANTS}
    walk_short = {v: _gru_walk_short(proj, ys_plain, gy, wh, bn, v)
                  for v in gru.VARIANTS}
    walk_shapes = _gru_walk_shapes(x_rng)
    # the backward's two designs, f32 and bf16 operands
    designs = {"gru_bwd": _gru_designs(proj, ys_plain, gy, wh, bn,
                                       torch.float32, tiny_bwd),
               "gru_bwd_bf16": _gru_designs(proj, ys16_plain, gy, wh, bn,
                                            b16, tiny_bwd)}

    fwd_bytes = 4 * (proj.numel() + ys.numel() + wh.numel() + bn.numel())
    fwd_ops = 2.0 * t * 2 * b * h * 3 * h
    bwd_bytes = 4 * (2 * proj.numel() + 2 * ys.numel() + 2 * wh.numel()
                     + 2 * bn.numel())
    # the hoisted backward in its two parts: the walk (gate recompute and
    # dh chain; reads proj, ys, gy, wh, bn, writes dproj and drznn) and
    # the dWh product (reads ys, dproj's r/z thirds and drznn, writes dwh
    # and dbn), timed apart and together
    walk_bound = _bound(4 * (2 * proj.numel() + 3 * ys.numel() + wh.numel()
                             + bn.numel()), {"f32": 2 * fwd_ops})
    product_bound = _bound(4 * (proj.numel() * 2 // 3 + 2 * ys.numel()
                                + wh.numel() + bn.numel()),
                           {"f32": fwd_ops})
    parts = {v: {"walk_bound_ms": walk_bound[0],
                 "dwh_product_bound_ms": product_bound[0]}
             for v in gru.VARIANTS}
    lib_fwd_ms = _cuda_ms(lambda: lib(x), 10)
    lib_fwd_bwd_ms = _cuda_ms(lib_fwd_bwd, 10)
    with torch.no_grad():
        lib16_ms = _cuda_ms(lambda: lib16(x16), 10)
    gy16_lib = gy_lib.to(b16)

    def lib16_fwd_bwd():
        out, _ = lib16(x16)
        out.backward(gy16_lib)

    lib16_grad_fwd_ms = _cuda_ms(lambda: lib16(x16), 10)
    lib16_fwd_bwd_ms = _cuda_ms(lib16_fwd_bwd, 10)
    rows = [
        dict(name="gru_fwd", got=ys, ref=ys_plain, tol=1e-4,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:62",
             plain=lambda: gru.gru_forward_plain(proj, wh, bn),
             bound=_bound(fwd_bytes, {"f32": fwd_ops}),
             library_ms=lib_fwd_ms, library_max_abs_diff=lib_gap,
             fwd_designs=fwd_designs["gru_fwd"]),
        dict(name="gru_bwd", got=grads, ref=grads_plain, tol=1e-4,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:199",
             plain=lambda: gru.gru_backward_plain(proj, ys_plain, gy, wh,
                                                  bn),
             bound=_bound(bwd_bytes, {"f32": 3 * fwd_ops}),
             library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
             library_fwd_bwd_ms=lib_fwd_bwd_ms,
             designs=designs["gru_bwd"]),
        dict(name="gru_fwd_bf16", got=ys16, ref=ys16_plain, tol=1e-2,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:62",
             plain=lambda: gru.gru_forward_plain(proj, wh, bn,
                                                 torch.bfloat16),
             bound=_bound(fwd_bytes, {"bf16": fwd_ops}),
             library_ms=lib16_ms, fwd_designs=fwd_designs["gru_fwd_bf16"],
             short_T=fwd_short),
        dict(name="gru_bwd_bf16", got=grads16, ref=grads16_plain,
             tol=GRU_B16_TOL, short_T=short,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:283",
             plain=lambda: gru.gru_backward_plain(proj, ys16_plain, gy, wh,
                                                  bn, b16),
             bound=_bound(bwd_bytes, {"bf16": 3 * fwd_ops}),
             library_ms=lib16_fwd_bwd_ms - lib16_grad_fwd_ms,
             library_fwd_bwd_ms=lib16_fwd_bwd_ms,
             designs=designs["gru_bwd_bf16"]),
    ] + [
        dict(name=f"gru_bwd_{v}", got=hoisted[v], ref=hoisted_plain[v],
             tol=1e-4, parts=parts[v],
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:"
             + {"v2": "540", "v3": "566"}[v],
             plain=lambda v=v: gru.gru_backward_hoisted_plain(
                 proj, ys_plain, gy, wh, bn, v == "v3"),
             bound=_bound(bwd_bytes, {"f32": 3 * fwd_ops}),
             library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
             library_fwd_bwd_ms=lib_fwd_bwd_ms,
             walk_designs=walk_designs[v], short_T=walk_short[v],
             other_shapes=[{"B": e["B"], "H": e["H"], "plan": e["plan"],
                            **e[v]} for e in walk_shapes])
        for v in gru.VARIANTS]
    out = []
    for row in rows:
        max_abs, rel = _max_err(row["got"], row["ref"])
        if rel > row["tol"]:
            raise AssertionError(f"{row['name']}: kernel disagrees with its "
                                 f"plain version: rel_rms {rel} > "
                                 f"{row['tol']} (max_abs {max_abs})")
        plain_ms = _cuda_ms(row["plain"], 2)
        extra = {k: row[k] for k in ("library_fwd_bwd_ms",
                                     "library_max_abs_diff", "short_T",
                                     "other_shapes")
                 if k in row}
        extra.update(row.get("parts", {}))
        source = "texttoaudiogrounding_tpu_torch/csrc/gru.cu"
        if "designs" in row:
            d = row["designs"]
            first = [_max_err(d["per_step"], row["ref"]),
                     _max_err(row["got"], d["per_step"]),
                     _max_err(d["rows_alt_grads"], row["ref"])]
            if max(e[1] for e in first) > row["tol"]:
                raise AssertionError(
                    f"{row['name']}: the first design off its plain version, "
                    f"the second design off the first or its {GRU_ROWS_ALT}"
                    f"-row plan off the plain version: rel_rms "
                    f"{[e[1] for e in first]} > {row['tol']}")
            kernel_ms = d["ms"]["cluster"]
            extra.update(
                per_step_ms=d["ms"]["per_step"], turns_ms=d["turns_ms"],
                rows_alt_ms=d["ms"]["rows_alt"], rows_alt=d["rows_alt"],
                rows_alt_rel_rms_err=first[2][1],
                latency_floor_ms=d["floor_ms"]["cluster"],
                per_step_latency_floor_ms=d["floor_ms"]["per_step"],
                per_step_rel_rms_err=first[0][1],
                vs_per_step_rel_rms=first[1][1],
                vs_per_step_max_abs=first[1][0], plan=d["plan"],
                clusters=d["clusters"],
                co_resident_clusters=d["co_resident_clusters"],
                cuda_launches_per_call=d["launches_per_call"]["cluster"],
                per_step_cuda_launches_per_call=d["launches_per_call"][
                    "per_step"],
                per_step_source=source)
            source = "texttoaudiogrounding_tpu_torch/csrc/gru_bwd_sm90.cu"
        elif "fwd_designs" in row:
            d = row["fwd_designs"]
            first = [_max_err(d["per_step"], row["ref"]),
                     _max_err(row["got"], d["per_step"])]
            if max(e[1] for e in first) > row["tol"]:
                raise AssertionError(
                    f"{row['name']}: the first design off its plain version "
                    f"or the second design off the first: rel_rms "
                    f"{[e[1] for e in first]} > {row['tol']}")
            kernel_ms = d["ms"]["cluster"]
            key = row["name"]
            extra.update(
                per_step_ms=d["ms"]["per_step"], turns_ms=d["turns_ms"],
                latency_floor_ms=d["floor_ms"]["cluster"],
                per_step_latency_floor_ms=d["floor_ms"]["per_step"],
                exchange_floor_ms=d["exchange_floor_ms"],
                per_step_rel_rms_err=first[0][1],
                vs_per_step_rel_rms=first[1][1],
                vs_per_step_max_abs=first[1][0], plan=d["plan"],
                clusters=d["clusters"],
                co_resident_clusters=d["co_resident_clusters"],
                cuda_launches_per_call=d["launches_per_call"]["cluster"],
                per_step_cuda_launches_per_call=d["launches_per_call"][
                    "per_step"],
                per_step_source=source,
                other_batches=[{"B": e["B"], **e[key]} for e in fwd_extra],
                odd_units=[{"B": e["B"], "H": e["H"], "plan": e["plan"],
                            "short_T": e["short_T"], **e[key]}
                           for e in fwd_odd])
            source = "texttoaudiogrounding_tpu_torch/csrc/gru_fwd_sm90.cu"
        elif "walk_designs" in row:
            d = row["walk_designs"]
            first = [_max_err(d["got"], d["plain"]),
                     _max_err(d["per_step"], d["plain"]),
                     _max_err(d["got"], d["per_step"])]
            if max(e[1] for e in first) > row["tol"]:
                rel = [e[1] for e in first]
                raise AssertionError(
                    f"{row['name']}: the cluster walk off the plain walk, "
                    f"the first design off it or the cluster walk off the "
                    f"first: rel_rms {rel} > {row['tol']}")
            kernel_ms = d["whole_ms"]["cluster"]
            extra.update(
                per_step_ms=d["whole_ms"]["per_step"],
                walk_ms=d["ms"]["cluster"],
                per_step_walk_ms=d["ms"]["per_step"],
                walk_turns_ms=d["turns_ms"],
                dwh_product_ms=d["dwh_product_ms"],
                latency_floor_ms=d["floor_ms"]["cluster"],
                per_step_latency_floor_ms=d["floor_ms"]["per_step"],
                exchange_floor_ms=d["exchange_floor_ms"],
                walk_rel_rms_err=first[0][1],
                per_step_walk_rel_rms_err=first[1][1],
                vs_per_step_rel_rms=first[2][1],
                vs_per_step_max_abs=first[2][0], plan=d["plan"],
                clusters=d["clusters"],
                co_resident_clusters=d["co_resident_clusters"],
                cuda_launches_per_call=d["launches_per_call"]["cluster"],
                per_step_cuda_launches_per_call=d["launches_per_call"][
                    "per_step"],
                per_step_source=source)
            source = "texttoaudiogrounding_tpu_torch/csrc/gru_walk_sm90.cu"
        else:
            kernel_ms = _cuda_ms(row["kernel"], 10)
        out.append({
            "name": row["name"], "route": "cuda",
            "source": source,
            "replaces": row["replaces"], "max_abs_err": max_abs,
            "rel_rms_err": rel, "tolerance": "rel_rms{} <= {}".format(
                "" if isinstance(row["got"], torch.Tensor)
                else " of each gradient", row["tol"]),
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "library": "torch.nn.GRU "
            f"({'bf16, ' if 'bf16' in row['name'] else ''}cuDNN; includes "
            "the input projection)", "T": t,
            "rows": 2 * b, "H": h, **extra})
    return out


# the conv2 outputs the pool kernels see in a batch-32 x 10 s step
POOL_GEOMETRIES = (("block1", 1001, 64, 64, (2, 2)),
                   ("block2", 500, 32, 128, (2, 2)),
                   ("block3", 250, 16, 256, (1, 2)),
                   ("block4", 250, 8, 512, (1, 2)))
_DUAL = ("texttoaudiogrounding_tpu_torch/csrc/dual_pool.cu",
         "texttoaudiogrounding_tpu/ops/pallas/dual_pool.py:263")
_BN = "texttoaudiogrounding_tpu/ops/pallas/bn_pool.py:376"
POOL_SOURCES = {"dual_pool_fwd": _DUAL, "dual_pool_bwd": _DUAL,
                "bn_pool_fwd": ("texttoaudiogrounding_tpu_torch/csrc/"
                                "bn_pool.cu", _BN),
                "bn_pool_bwd": ("texttoaudiogrounding_tpu_torch/csrc/"
                                "bn_pool_v2.cu", _BN),
                "bn_pool_stats": ("texttoaudiogrounding_tpu_torch/csrc/"
                                  "bn_pool_v2.cu", _BN)}
# bn_pool_stats against plain batch_stats: var within STATS_VAR_TOL
# relative, mean within STATS_MEAN_TOL times the channel's std
STATS_VAR_TOL, STATS_MEAN_TOL = 1e-4, 1e-5


def _stats_err(got, ref) -> tuple:
    """(max abs error, worst share of its limit, var rel, mean / std) of
    ``(mean, var)`` against the plain ``(mean, var)``."""
    (gm, gv), (rm, rv) = got, ref
    var_rel = float(((gv - rv).abs() / rv).max())
    mean_std = float(((gm - rm).abs() / rv.sqrt()).max())
    max_abs = max(float((gm - rm).abs().max()), float((gv - rv).abs().max()))
    return max_abs, max(var_rel / STATS_VAR_TOL, mean_std / STATS_MEAN_TOL), \
        var_rel, mean_std


def _bwd_designs(x, g, mean, inv, gamma, beta, pool, plain,
                 label: str) -> dict:
    """The backward's second design against the first (``three_pass``) on
    the same inputs (1e-4), the first against its plain version ``plain()``
    (1e-4), the same bits on two calls, both timed in turns
    (three_pass, two_pass, two_pass, three_pass; 10 calls each) and each
    design's CUDA launches a call counted by the profiler (two_pass must
    make 2; three_pass makes its 3 and the wrapper's ``γ·inv`` and
    ``torch.stack``)."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool

    def call(design):
        return lambda: bn_pool.bn_pool_bwd(x, g, mean, inv, gamma, beta,
                                           pool, design=design)

    first, again, old = call("two_pass")(), call("two_pass")(), \
        call("three_pass")()
    vs_first = _max_err(first, old)
    if vs_first[1] > 1e-4:
        raise AssertionError(f"bn_pool_bwd ({label}): the two designs "
                             f"disagree: rel_rms {vs_first[1]} > 1e-4")
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"bn_pool_bwd ({label}): two calls differ in "
                             "bits")
    del first, again
    vs_plain = _max_err(old, plain())
    if vs_plain[1] > 1e-4:
        raise AssertionError(f"bn_pool_bwd ({label}): three_pass disagrees "
                             f"with its plain version: rel_rms {vs_plain[1]} "
                             "> 1e-4")
    del old
    order = ("three_pass", "two_pass")
    runs = [(d, _cuda_ms(call(d), 10)) for d in order + order[::-1]]
    per_call = {d: _launches_per_call(call(d)) for d in order}
    if per_call["two_pass"] != 2:
        raise AssertionError(f"bn_pool_bwd ({label}): CUDA launches a call "
                             f"{per_call}, expected 2 for two_pass")
    return {"ms_turns": {d: sum(ms for n, ms in runs if n == d) / 2
                         for d in order},
            "turns_ms": runs, "launches_per_call": per_call,
            "vs_three_pass": {"max_abs_err": vs_first[0],
                              "rel_rms_err": vs_first[1]},
            "three_pass_vs_plain": {"max_abs_err": vs_plain[0],
                                    "rel_rms_err": vs_plain[1]},
            "same_bits_twice": True}


def _pool_chains(x, g, gamma, beta, pool):
    """The plain PyTorch chains the pool kernels replace, forward +
    backward (ReLU, or train-mode BN with f32 statistics then ReLU, and
    ``F.avg_pool2d + F.max_pool2d``), and the same work through the
    kernels' autograd functions."""
    import torch
    import torch.nn.functional as F

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool, dual_pool

    def pools(h):
        h = h.permute(0, 3, 1, 2)
        return (F.avg_pool2d(h, pool) + F.max_pool2d(h, pool)).permute(
            0, 2, 3, 1)

    def relu_chain():
        xx = x.detach().requires_grad_()
        pools(torch.relu(xx)).backward(g)

    def bn_chain():
        xx, gg, bb = (v.detach().requires_grad_() for v in (x, gamma, beta))
        xf = xx.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 1, 2)) - mean * mean,
                              0.0)
        h = ((xx - mean) * (torch.rsqrt(var + 1e-5) * gg) + bb).to(x.dtype)
        pools(torch.relu(h)).backward(g)

    def relu_kernel():
        xx = x.detach().requires_grad_()
        dual_pool.dual_pool_relu(xx, pool).backward(g)

    def bn_kernel():
        xx, gg, bb = (v.detach().requires_grad_() for v in (x, gamma, beta))
        bn_pool.bn_relu_dual_pool(xx, gg, bb, pool)[0].backward(g)

    return {"dual_pool": (relu_chain, relu_kernel),
            "bn_pool": (bn_chain, bn_kernel)}


def pool_kernel_phase(clips: int) -> list:
    """The pool kernels against their plain versions at the four blocks'
    bf16 geometries (and block 1 in f32); one row per kernel, its times
    the sum over the four bf16 blocks, each geometry listed."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool, dual_pool

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(n, t, m, c, p, torch.bfloat16)
             for n, t, m, c, p in POOL_GEOMETRIES]
    cases.append(("block1_f32", 1001, 64, 64, (2, 2), torch.float32))
    geos = {k: [] for k in POOL_SOURCES}
    tol = {"dual_pool_fwd": 1e-5, "dual_pool_bwd": 1e-5, "bn_pool_fwd": 1e-5,
           "bn_pool_bwd": 1e-4, "bn_pool_stats": 1.0}
    for label, t, m, c, pool, dtype in cases:
        pt = pool[0]
        # a conv output's spread, in bf16 with the ties bf16 makes
        x = torch.randn(clips, t, m, c, device=dev, generator=gen).to(dtype)
        g = torch.randn(clips, t // pt, m // 2, c, device=dev,
                        generator=gen).to(dtype)
        gamma = torch.rand(c, device=dev, generator=gen) + 0.5
        beta = torch.randn(c, device=dev, generator=gen) * 0.1
        mean, var = bn_pool.batch_stats(x)
        inv = torch.rsqrt(var + 1e-5)
        sc, sh = gamma * inv, beta - mean * gamma * inv
        calls = {
            "dual_pool_fwd": (lambda: dual_pool.dual_pool_fwd(x, pool),
                              lambda: dual_pool.dual_pool_fwd_plain(x, pool)),
            "dual_pool_bwd": (
                lambda: dual_pool.dual_pool_bwd(x, g, pool),
                lambda: dual_pool.dual_pool_bwd_plain(x, g, pool)),
            "bn_pool_fwd": (
                lambda: bn_pool.bn_pool_fwd(x, sc, sh, pool),
                lambda: bn_pool.bn_pool_fwd_plain(x, sc, sh, pool)),
            "bn_pool_bwd": (
                lambda: bn_pool.bn_pool_bwd(x, g, mean, inv, gamma, beta,
                                            pool),
                lambda: bn_pool.bn_pool_bwd_plain(x, g, mean, inv, gamma,
                                                  beta, pool)),
            "bn_pool_stats": (lambda: bn_pool.batch_stats(x),
                              lambda: bn_pool.batch_stats_plain(x)),
        }
        # bytes moved; at under 20 f32 operations per input element their
        # time is below a third of the bytes' on every row
        es, nx = x.element_size(), x.numel()
        nbytes = {"dual_pool_fwd": nx * es * (1 + 0.5 / pt),
                  "dual_pool_bwd": nx * es * (2 + 0.5 / pt),
                  "bn_pool_fwd": nx * es * (1 + 0.5 / pt) + 8 * c,
                  "bn_pool_bwd": nx * es * (2 + 0.5 / pt) + 24 * c,
                  "bn_pool_stats": nx * es + 8 * c}
        chains = _pool_chains(x, g, gamma, beta, pool)
        for name, (kern, plain) in calls.items():
            got, ref = kern(), plain()
            if name == "bn_pool_stats":
                max_abs, rel, var_rel, mean_std = _stats_err(got, ref)
                extra = {"var_rel_err": var_rel, "mean_err_over_std": mean_std}
            else:
                if isinstance(got, torch.Tensor):
                    got, ref = (got,), (ref,)
                errs = [_err(a, b) for a, b in zip(got, ref)]
                max_abs = max(e[0] for e in errs)
                rel = max(e[1] for e in errs)
                extra = {}
            if rel > tol[name]:
                raise AssertionError(f"{name} ({label}): kernel disagrees "
                                     f"with its plain version: "
                                     f"{extra or 'rel_rms'} {rel} > "
                                     f"{tol[name]} (max_abs {max_abs})")
            del got, ref
            ms = _cuda_ms(kern, 10)
            device_ms = _trace(lambda kern=kern: [kern() for _ in range(10)],
                               10 * ms)["pool_ms"] / 10
            entry = {"geometry": label, "dtype": str(dtype).split(".")[1],
                     "x_shape": [clips, t, m, c], "pool": list(pool),
                     "max_abs_err": max_abs, "rel_rms_err": rel, **extra,
                     "ms": ms, "device_ms": device_ms,
                     "plain_ms": _cuda_ms(plain, 3),
                     "bound": _bound(nbytes[name], {})}
            if name.endswith("_bwd"):      # forward + backward, information
                chain, through = chains[name.split("_bwd")[0]]
                entry["chain_fwd_bwd_ms"] = _cuda_ms(chain, 5)
                entry["kernel_fwd_bwd_ms"] = _cuda_ms(through, 5)
            if name == "bn_pool_bwd":
                entry.update(_bwd_designs(x, g, mean, inv, gamma, beta, pool,
                                          plain, label))
                # two streaming passes: x and g read twice, dx written
                entry["floor_ms"] = nx * es * (3 + 1 / pt) / HBM * 1e3
            if name == "bn_pool_stats":
                xf = lambda: torch.var_mean(x.float(), dim=(0, 1, 2),
                                            correction=0)
                entry["library_ms"] = _cuda_ms(xf, 10)
                if label == "block1":
                    entry["shifted"] = _stats_shifted(x)
            geos[name].append(entry)
        del x, g
        torch.cuda.empty_cache()
    rows = []
    for name, entries in geos.items():
        main = [e for e in entries if e["dtype"] == "bfloat16"]
        source, replaces = POOL_SOURCES[name]
        for e in entries:
            e["bound_ms"], e["bound_by"] = e.pop("bound")
        extra = {}
        if name == "bn_pool_bwd":
            extra = {
                "three_pass_ms": sum(e["ms_turns"]["three_pass"]
                                     for e in main),
                "two_pass_turns_ms": sum(e["ms_turns"]["two_pass"]
                                         for e in main),
                "floor_ms": sum(e["floor_ms"] for e in main),
                "launches_per_call": main[0]["launches_per_call"],
                "three_pass": "csrc/bn_pool.cu, bn_pool_bwd(..., "
                              "design=\"three_pass\"), timed in turns"}
        library = (None, "none: no single PyTorch call computes it")
        if name == "bn_pool_stats":
            library = (sum(e["library_ms"] for e in main),
                       "torch.var_mean(x.float(), dim=(0, 1, 2), "
                       "correction=0)")
            extra = {"tolerance": f"var within {STATS_VAR_TOL} relative, "
                     f"mean within {STATS_MEAN_TOL} std (rel_rms_err: the "
                     "worst share of those limits)",
                     "replaces_part": "the batch statistics of "
                     "bn_relu_dual_pool, bn_pool.py:395-398 (XLA "
                     "reductions)"}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(e["max_abs_err"] for e in entries),
            "rel_rms_err": max(e["rel_rms_err"] for e in entries),
            "tolerance": f"rel_rms <= {tol[name]}",
            "ms": sum(e["ms"] for e in main),
            "kernel_ms": sum(e["ms"] for e in main),
            "device_ms": sum(e["device_ms"] for e in main),
            "plain_ms": sum(e["plain_ms"] for e in main),
            "bound_ms": sum(e["bound_ms"] for e in main),
            "bound_by": main[0]["bound_by"], "library_ms": library[0],
            "library": library[1], **extra,
            "times": "sum over the four bf16 blocks of a batch-32 x 10 s "
                     "step", "clips": clips, "geometries": entries})
    return rows


def _stats_shifted(x) -> dict:
    """``bn_pool_stats`` against plain ``batch_stats`` on x·0.5 + 3, where
    ``E[x²] − mean²`` cancels (block 1: 2.05 M elements a channel)."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool

    xs = (x.float() * 0.5 + 3.0).to(x.dtype)
    max_abs, share, var_rel, mean_std = _stats_err(bn_pool.batch_stats(xs),
                                                   bn_pool.batch_stats_plain(xs))
    if share > 1.0:
        raise AssertionError(f"bn_pool_stats (x 0.5 + 3): var rel {var_rel} "
                             f"(limit {STATS_VAR_TOL}), mean / std {mean_std} "
                             f"(limit {STATS_MEAN_TOL})")
    return {"input": "x * 0.5 + 3", "max_abs_err": max_abs,
            "var_rel_err": var_rel, "mean_err_over_std": mean_std}


def _embedding_gap(plain, served: list) -> float:
    """Largest relative RMS gap of the served audio embeddings to the plain
    path's on the same inputs; ``served`` holds (input, embedding) pairs
    of the audio encoder's forwards."""
    import torch
    gaps = []
    with torch.no_grad():
        for inp, got in served:
            ref = plain.audio_encoder(inp)["embedding"].double()
            d = got.double() - ref
            gaps.append(float(torch.sqrt((d ** 2).mean()
                                         / (ref ** 2).mean())))
    return max(gaps)


# kernel launches of one int8 serving forward (the rest launch none)
SERVING_PER_FORWARD = {"logmel": 1, "conv_block1_pair": 1,
                       "conv_block_pair": 1, "conv_block": 2}


def _request(rng, lens: list) -> tuple:
    """(audio [B, max len] with noise up to each length, B phrases)."""
    import numpy as np
    audio = np.zeros((len(lens), max(lens)), np.float32)
    for i, ln in enumerate(lens):
        audio[i, :ln] = rng.normal(0, 0.1, ln)
    text = [" ".join(f"w{int(v)}" for v in rng.integers(2, 5000, 3))
            for _ in lens]
    return audio, text


def _checked_request(pred, pred_plain, plain, served: list, label: str,
                     audio, lens, text, per_forward: dict,
                     totals: dict) -> dict:
    """One ``predict`` held to the serving correctness contract (PERF.md
    §2): every kernel's count rises by ``per_forward`` per sub-batch (and
    no other count rises), the reference lengths, ``frame_sim`` finite in
    (0, 1] with padded frames zero and within 0.05 of the all-plain f32
    path, and each sub-batch's audio embedding (the forward hook's
    ``served`` pairs) within 5 % relative RMS of the plain path's.  Adds
    the launches to ``totals``."""
    import numpy as np
    import torch

    before = _counts()
    served.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, lengths = pred.predict(audio, lens, text, return_length=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    subs = len(pred._chunk_plan(len(lens)))
    for k, n in _counts().items():
        grew = n - before[k]
        if grew != subs * per_forward.get(k, 0):
            raise AssertionError(f"{label}: {k} launched {grew} times, "
                                 f"expected {subs * per_forward.get(k, 0)}")
        totals[k] += grew
    want = (np.asarray(lens) // 320 + 1) // 4
    if not np.array_equal(lengths, want):
        raise AssertionError(f"{label}: lengths {lengths} != {want}")
    valid = np.arange(probs.shape[1])[None] < lengths[:, None]
    if not (np.isfinite(probs).all() and (probs[valid] > 0).all()
            and (probs[valid] <= 1).all() and not probs[~valid].any()):
        raise AssertionError(f"{label}: frame_sim out of (0, 1]")
    ref = pred_plain.predict(audio, lens, text)
    delta = float(np.max(np.abs(probs - ref)))
    if delta >= 0.05:
        raise AssertionError(f"{label}: |frame_sim - plain f32| = "
                             f"{delta} >= 0.05")
    if len(served) != subs:
        raise AssertionError(f"{label}: {len(served)} audio forwards, "
                             f"expected {subs}")
    emb_rel = _embedding_gap(plain, served)     # int8 noise, < 5 %
    if emb_rel >= 0.05:
        raise AssertionError(f"{label}: audio embedding off the plain "
                             f"f32 path by {emb_rel} (relative RMS)")
    return {"request": label, "clips": len(lens), "sub_batches": subs,
            "seconds": seconds, "max_abs_vs_plain_f32": delta,
            "embedding_rel_rms_vs_plain_f32": emb_rel,
            "frame_sim_mean": float(probs[valid].mean())}


def serving_phase(rng, tok) -> dict:
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import (
        GroundingPredictor, flagship_model, random_state_dict)

    model = flagship_model(serving=True, device=DEVICE)
    sd = random_state_dict(model, seed=0)
    model.load_state_dict(sd)
    plain = flagship_model(serving=False, device=DEVICE, gru_kernel=False)
    plain.load_state_dict(sd)
    pred = GroundingPredictor(model, tok)
    pred_plain = GroundingPredictor(plain, tok)

    n = SR * CLIP_S
    requests = [
        ("3 clips, 10/7.8/5 s", [n, 250000, 160000]),
        ("1 clip, 4.3 s", [137600]),
        ("32 clips, 10 s", [n] * 32),
    ]
    # random weights keep frame_sim near 0.5: each sub-batch's audio
    # embedding is also held to the plain f32 path on the same input
    served = []
    hook = model.audio_encoder.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"])))
    _reset_counts()
    totals = _counts()                  # launches by predict() alone
    results = []
    for label, lens in requests:
        audio, text = _request(rng, lens)
        results.append(_checked_request(pred, pred_plain, plain, served,
                                        label, audio, lens, text,
                                        SERVING_PER_FORWARD, totals))
    hook.remove()
    served.clear()

    # the bf16 GRU kernel opted in (JAX: TTG_PALLAS_GRU=1), held to the
    # plain path on the largest request as the default path is
    label, lens = requests[-1]
    audio = (rng.normal(0, 0.1, (len(lens), n))).astype(np.float32)
    text = [" ".join(f"w{int(v)}" for v in rng.integers(2, 5000, 3))
            for _ in lens]
    model_gk = flagship_model(serving=True, device=DEVICE, gru_kernel=True)
    model_gk.load_state_dict(sd)
    pred_gk = GroundingPredictor(model_gk, tok)
    hook = model_gk.audio_encoder.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"])))
    _reset_counts()
    probs = pred_gk.predict(audio, lens, text)
    torch.cuda.synchronize()
    gru_launches = _counts()["gru_fwd_bf16"]
    hook.remove()
    if gru_launches != len(pred_gk._chunk_plan(len(lens))):
        raise AssertionError(f"bf16 GRU kernel launched {gru_launches} "
                             "times for one request")
    delta = float(np.max(np.abs(probs - pred_plain.predict(audio, lens,
                                                           text))))
    emb_rel = _embedding_gap(plain, served)
    served.clear()
    if delta >= 0.05 or emb_rel >= 0.05:
        raise AssertionError(f"bf16 GRU kernel path: |frame_sim - plain| "
                             f"{delta}, embedding {emb_rel} (limits 0.05)")

    # block 1 all in int8 (JAX: TTG_B1_QUANT=1) on the largest request,
    # held to the contract as the default path is; block 1's input (the
    # bn0 output) and output in this served batch feed the designs phase
    model8 = flagship_model(serving=True, device=DEVICE,
                            block1_quant="int8")
    model8.load_state_dict(sd)
    pred8 = GroundingPredictor(model8, tok)
    enc8 = model8.audio_encoder
    block1_io, block2_out = [], []
    hooks = [enc8.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"]))),
        enc8.conv_block1.register_forward_hook(
            lambda mod, args, out: block1_io.append((args[0], out))),
        enc8.conv_block2.register_forward_hook(
            lambda mod, args, out: block2_out.append(out))]
    _reset_counts()
    b1_totals = _counts()
    b1_request = _checked_request(
        pred8, pred_plain, plain, served, f"{label}, block 1 int8", audio,
        lens, text, {**SERVING_PER_FORWARD, "conv_block1_pair": 0,
                     "conv_block1_pair_int8": 1}, b1_totals)
    for hook in hooks:
        hook.remove()
    served.clear()
    handoff = (block1_io[0][0][..., 0].contiguous(),
               block1_io[0][1].contiguous(), enc8,
               block2_out[0].contiguous(),
               torch.from_numpy(audio).to(DEVICE))
    del block1_io, block2_out

    # block 1 all in int8 in the single staging (JAX: TTG_B1_QUANT=1
    # TTG_B1_MODE=single), held to the contract as the default path is
    model_s = flagship_model(serving=True, device=DEVICE,
                             block1_quant="int8", block1_mode="single")
    model_s.load_state_dict(sd)
    pred_s = GroundingPredictor(model_s, tok)
    hook = model_s.audio_encoder.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"])))
    _reset_counts()
    single_totals = _counts()
    single_request = _checked_request(
        pred_s, pred_plain, plain, served, f"{label}, block 1 int8 single",
        audio, lens, text, {**SERVING_PER_FORWARD, "conv_block1_pair": 0,
                            "conv_block1_pair_single": 1}, single_totals)
    hook.remove()
    served.clear()

    # steady-state throughput of the largest request, four ways
    paths = {}
    for name, p in (("default", pred), ("gru_kernel", pred_gk),
                    ("block1_int8", pred8), ("block1_single", pred_s)):
        p.predict(audio, lens, text)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.predict(audio, lens, text)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        secs = float(np.median(times))
        paths[name] = {"clips_per_s": len(lens) / secs, "request_s": secs,
                       "request_s_all": times,
                       "trace": _trace(lambda p=p: p.predict(audio, lens,
                                                             text),
                                       secs * 1e3)}
    paths["gru_kernel"].update(max_abs_vs_plain_f32=delta,
                               embedding_rel_rms_vs_plain_f32=emb_rel)
    paths["block1_int8"].update(b1_request)
    paths["block1_single"].update(single_request)
    return {"requests": results, "launches": totals,
            "gru_fwd_bf16_launches": gru_launches,
            "block1_int8_launches": b1_totals,
            "block1_single_launches": single_totals,
            "clips_per_s": paths["default"]["clips_per_s"],
            "largest": label, "paths": paths}, handoff


def _block_weights(blk) -> tuple:
    """(w1, ab1, w2, ab2) of a ``ConvBlock``: HWIO f32, BN folded."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import fold_bn
    with torch.no_grad():
        return (blk.conv1.weight.detach().permute(2, 3, 1, 0),
                fold_bn(blk.bn1.weight, blk.bn1.bias, blk.bn1.running_mean,
                        blk.bn1.running_var, blk.bn1.eps),
                blk.conv2.weight.detach().permute(2, 3, 1, 0),
                fold_bn(blk.bn2.weight, blk.bn2.bias, blk.bn2.running_mean,
                        blk.bn2.running_var, blk.bn2.eps))


_DESIGN_TOL = "max_abs == 0 (int8); bf16 mode rel_rms <= 0.01"
# row 9 against its plain version on the same waveform: one bf16 ulp of a
# power bin, 10 log10(1 + 2^-7) = 0.034 dB, where the kernel's and the
# plain version's f32 DFT sums round the power to different sides; in the
# mean, far below the 3.9e-3 dB by which row 1's f32 mel projection
# differs from v3's bf16 one (CPU, 2 x 3 s of noise), which the control
# below must show on the card
V3_MAX_DB, V3_MEAN_DB = 0.035, 1e-4


def _bit_exact(out, target) -> dict:
    max_abs, rel = _err(out, target)
    if max_abs != 0.0:
        raise AssertionError(f"differs from its plain version: max_abs "
                             f"{max_abs}, rel_rms {rel}")
    return {"max_abs_err": max_abs, "rel_rms_err": rel}


def _design(kernel, plain, ref, ops, in_bytes, source, replaces, *,
            check=_bit_exact, tolerance=_DESIGN_TOL, target=None, bf16=None,
            beside=None, timed=None, counter=None, trace=False,
            designs=None, **extra) -> dict:
    """One record of the designs table.  ``kernel()`` runs the design as
    its route does (weights laid out once) and ``plain()`` its plain
    version; ``check(out, target())`` holds the counted run's output
    against ``target`` (the plain version if None); ``ref`` is (label,
    tensor) of the f32 block or f64 log-mel it is compared with; ``ops``
    {type: count} and ``in_bytes`` (output bytes added) give its bound;
    ``bf16`` is (kernel, plain) of the bf16 mode, held within 1e-2
    relative RMS; ``beside`` {name: fn} are other kernels timed in the same
    call and compared with ``ref`` (and with ``trace``, traced by launch
    as the design is), ``timed`` {name: fn} are only timed;
    ``counter`` is the launch counter where it is not the record's name;
    ``designs()``, if given, runs last and its dict (a redesigned row's
    first design, timed in turns) goes into the row;
    ``extra`` goes into the JSON row as it is."""
    return {"kernel": kernel, "plain": plain, "ref": ref, "ops": ops,
            "in_bytes": in_bytes, "source": source, "replaces": replaces,
            "check": check, "tolerance": tolerance,
            "target": target or plain, "bf16": bf16, "beside": beside or {},
            "timed": timed or {}, "counter": counter, "trace": trace,
            "designs": designs, "extra": extra}


def _design_row(name: str, d: dict, out) -> dict:
    """Check, time and report one design (its counted run gave ``out``)."""
    try:
        errs = d["check"](out, d["target"]())
    except AssertionError as e:
        raise AssertionError(f"{name}: {e}") from None
    label, ref = d["ref"]

    def vs_ref(key, got):
        # the padded frames off
        return {f"{key}max_abs_vs_{label}": _err(got[:, :ref.shape[1]],
                                                 ref)[0],
                f"{key}rel_rms_vs_{label}": _err(got[:, :ref.shape[1]],
                                                 ref)[1]}

    ms = _cuda_ms(d["kernel"], 10)
    nbytes = d["in_bytes"] + out.numel() * out.element_size()
    bound_ms, bound_by = _bound(nbytes, d["ops"])
    row = {"name": name, "route": "cuda",
           "source": f"texttoaudiogrounding_tpu_torch/csrc/{d['source']}",
           "replaces": f"texttoaudiogrounding_tpu/ops/pallas/"
                       f"{d['replaces']}",
           **errs, "tolerance": d["tolerance"], "ms": ms, "kernel_ms": ms,
           "plain_ms": _cuda_ms(d["plain"], 3), "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "library": "none: no single PyTorch call computes it",
           "input_bytes": d["in_bytes"], **vs_ref("", out)}
    if d["counter"]:
        row["counter"] = d["counter"]
    if d["bf16"]:
        kern16, plain16 = d["bf16"]
        got16 = kern16()
        b16 = _err(got16, plain16())[1]
        if b16 > 1e-2:
            raise AssertionError(f"{name} (bf16): kernel disagrees with its "
                                 f"plain version: rel_rms {b16} > 0.01")
        row.update({"bf16_mode_rel_rms_err": b16,
                    "bf16_ms": _cuda_ms(kern16, 10),
                    "bf16_bound_ms": _bound(nbytes, {
                        "bf16": sum(d["ops"].values())})[0],
                    **vs_ref("bf16_", got16)})
    for key, fn in d["beside"].items():
        row.update({f"{key}_ms": _cuda_ms(fn, 10), **vs_ref(f"{key}_", fn())})
        if d["trace"]:
            row[f"{key}_trace"] = _trace(fn, row[f"{key}_ms"], by_launch=True)
    for key, fn in d["timed"].items():
        row[f"{key}_ms"] = _cuda_ms(fn, 10)
    if d["trace"]:
        # device time by launch
        row["trace"] = _trace(d["kernel"], ms, by_launch=True)
    row.update(d["extra"])
    if d["designs"]:
        row.update(d["designs"]())
    return row


def designs_phase(x1, y1, enc, y2, wave) -> tuple:
    """The JAX package's designs that no shipped model routes, on the
    served batch: block 1's all-int8 mode in both stagings (row 2) and rows
    5-7 on x1, the bn0 output ``[B, T, 64]`` that entered block 1, and y1,
    block 1's output, with the served blocks-1-2 weights; row 8 on y2, its
    block-2 output, and row 8's own block-3 output; rows 9-10 on its
    waveform.  Each design runs once as the JAX package drives it (its
    launches counted, exactly one per design), then each record of the one
    table is checked, timed and reported by :func:`_design_row`.  Returns
    (records, launches, the reports of :func:`_v1_route` and
    :func:`_row7_mels`)."""
    import collections

    import torch

    designs = _block12_designs(x1, y1, enc)
    loud = _single_loud_frame(x1, _block_weights(enc.conv_block1))
    designs["conv_block1_pair_single"]["extra"]["loud_frame"] = loud
    _reset_counts()
    outs = {name: d["kernel"]() for name, d in designs.items()}
    for more, got in (_wino_designs(enc, y2), _slab_designs(enc, y2),
                      _logmel_designs(wave)):
        designs.update(more)
        outs.update(got)
    torch.cuda.synchronize()
    launches = _counts()
    want = _want(**collections.Counter(d["counter"] or name
                                       for name, d in designs.items()))
    if launches != want:
        raise AssertionError(f"designs: launches {launches}, expected "
                             f"{want}")
    rows = []
    for name, d in designs.items():
        rows.append(_design_row(name, d, outs.pop(name)))
        torch.cuda.empty_cache()
    return rows, launches, {**_v1_route(y1, enc), **_row7_mels(x1, enc)}


# the public function of each row whose second design takes no time pairs
# at M = 4, and the first design's counter its call must raise
V1_ROUTE = {"conv_block_pair": "conv_block_pair_v1",
            "conv_block": "conv_block_v1",
            "pair_conv_pool": "pair_conv_pool_v1",
            "block2_small": "block2_small_v1"}


def _v1_route(y1, enc) -> dict:
    """Rows 3, 4 direct9, 5 and 6 at M = 4, pool (2, 2), on 3 clips x 16
    frames x the first 4 mels of the served block-1 output, with the served
    block-2 weights: each through its public function must equal its plain
    version bit for bit in int8, by way of its first design
    (``conv_block.v2_takes``), raising that design's counter by one and no
    other."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        block2_small, conv_block, conv_block_pair, pair_conv_pool)

    w = _block_weights(enc.conv_block2)
    x = y1[:3, :16, :4].contiguous()
    t, m = x.shape[1:3]
    if conv_block.v2_takes(m, (2, 2)):
        raise AssertionError(f"the second design takes M = {m}")
    tc3 = conv_block_pair.pick_tc_pair(t, m // 2, 128, True)
    tc4 = conv_block.block_tc(x.shape, 128, (2, 2), True, (False,) * 4)
    tc5 = pair_conv_pool.pick_tc(t, m // 2, 2)
    tc6 = block2_small.default_tc(t)
    runs = {
        "conv_block_pair": (
            lambda: conv_block_pair.fused_block2_pair(x, *w, quantize=True),
            lambda: conv_block_pair.block2_plain(x, *w, quantize=True,
                                                 tc=tc3), tc3),
        "conv_block": (
            lambda: conv_block.fused_double_conv_pool(x, *w, (2, 2),
                                                      quantize=True),
            lambda: conv_block.block_plain(x, *w, (2, 2), quantize=True,
                                           tc=tc4), tc4),
        "pair_conv_pool": (
            lambda: pair_conv_pool.fused_pair_conv_pool(x, *w,
                                                        quantize=True),
            lambda: pair_conv_pool.pair_conv_pool_plain(x, *w, quantize=True,
                                                        tc=tc5), tc5),
        "block2_small": (
            lambda: block2_small.fused_block2(x, *w),
            lambda: conv_block_pair.block2_plain(x, *w, quantize=True,
                                                 tc=tc6, divide=True), tc6)}
    out = {}
    for name, (run, plain, tc) in runs.items():
        _reset_counts()
        got = run()
        torch.cuda.synchronize()
        counts = _counts()
        want = _want(**{V1_ROUTE[name]: 1})
        if counts != want:
            raise AssertionError(f"{name} at M = {m}: launches "
                                 f"{ {k: v for k, v in counts.items() if v} }"
                                 f", expected {V1_ROUTE[name]} once")
        max_abs = _err(got, plain())[0]
        if max_abs != 0.0:
            raise AssertionError(f"{name} at M = {m}: max_abs {max_abs} to "
                                 f"its plain version")
        out[name] = {"counter": V1_ROUTE[name], "max_abs_err": max_abs,
                     "tc": tc, "shape": list(x.shape)}
    return out


# row 7 at mel counts other than the flagship's 64: the public function's
# design at each (M 32 takes the second, 48 the first) and its counter
ROW7_MELS = {32: "block1_small", 48: "block1_small_v1"}


def _row7_mels(x1, enc) -> dict:
    """Row 7 (``block1_small.fused_block1``) at M = 32 and 48 on 4 clips of
    the served block-1 input cut to its first M mels, with the served
    block-1 weights: int8 bit for bit and the bf16 mode within 1e-2
    relative RMS of its plain version, each call raising ROW7_MELS[M] by
    one and no other counter; at M = 32 the second design also bit for bit
    to the first (int8)."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import block1_small

    w = _block_weights(enc.conv_block1)
    out = {}
    for m, counter in ROW7_MELS.items():
        x = x1[:4, :, :m].contiguous()
        tc = block1_small.default_tc(x.shape[1])
        rec = {"counter": counter, "tc": tc, "shape": list(x.shape)}
        for q, key in ((True, "int8"), (False, "bf16")):
            def run(q=q):
                return block1_small.fused_block1(x, *w, quantize=q)
            _reset_counts()
            got = run()
            torch.cuda.synchronize()
            counts = _counts()
            if counts != _want(**{counter: 1}):
                raise AssertionError(
                    f"block1_small at M = {m}: launches "
                    f"{ {k: v for k, v in counts.items() if v} }, expected "
                    f"{counter} once")
            plain = block1_small.block1_small_plain(x, *w, quantize=q, tc=tc)
            max_abs, rel = _err(got, plain)
            if (q and max_abs != 0.0) or rel > 1e-2:
                raise AssertionError(f"block1_small at M = {m} ({key}): "
                                     f"max_abs {max_abs}, rel_rms {rel} to "
                                     f"its plain version")
            rec.update({f"{key}_max_abs_err": max_abs,
                        f"{key}_rel_rms_err": rel,
                        f"{key}_ms": _cuda_ms(run, 10)})
            if q and counter == "block1_small":
                vs_v1 = _err(got, block1_small._fused_block1_v1(
                    x, *w, quantize=True))[0]
                if vs_v1 != 0.0:
                    raise AssertionError(f"block1_small at M = {m}: the "
                                         f"first design differs by {vs_v1}")
                rec["v1_max_abs_err"] = vs_v1
        out[f"block1_small_m{m}"] = rec
    return out


def _block12_designs(x1, y1, enc) -> dict:
    """Rows 2 (``True`` and ``single``) and 5-7 on the served block-1 input
    and output, beside the routed rows 2 / 3 on the same input."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        block1_small, block2_small, conv_block, conv_block1_pair,
        conv_block_pair, pair_conv_pool)
    from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
        _quant_i8, over127)

    b1w, b2w = _block_weights(enc.conv_block1), _block_weights(
        enc.conv_block2)
    clips, t1, _ = x1.shape
    t2 = y1.shape[1]
    with torch.no_grad():
        f32_1 = ("f32_block", enc.conv_block1._plain(x1.float()[..., None],
                                                     (2, 2)))
        f32_2 = ("f32_block", enc.conv_block2._plain(y1.float(), (2, 2)))
        # block 1 without conv1: the f32 conv1 activation, int8 with one
        # scale, T padded with zero frames to whole chunks (the caller's
        # part, conv_block.py:741-749)
        w1, (a1, c1), w2, ab2 = b1w
        conv1 = torch.nn.functional.conv2d(
            x1.float()[:, None], w1.permute(3, 2, 0, 1), padding=1)
        act = torch.relu(conv1.permute(0, 2, 3, 1) * a1 + c1)
        xs = over127(act.amax())
        tp = -(-t1 // 48) * 48
        aq = torch.nn.functional.pad(_quant_i8(act, 1.0 / xs),
                                     (0, 0, 0, 0, 0, tp - t1)).contiguous()
        a16 = torch.nn.functional.pad(act.to(torch.bfloat16),
                                      (0, 0, 0, 0, 0, tp - t1)).contiguous()
    # each mode's weights laid out once, as the routes keep them
    prep = {
        ("b1", q): conv_block1_pair.kernel_weights(*b1w, q)
        for q in ("conv1", True, False)}
    prep.update({("b1s", q): block1_small.prepare(*b1w, q)
                 for q in (True, False)})
    prep.update({("c2", q): pair_conv_pool.prepare(
        None, None, w2, ab2, q, xs if q else None) for q in (True, False)})
    prep.update({("b2", q): conv_block.kernel_weights(*b2w, q)
                 for q in (True, False)})
    prep.update({("b2s", q): block2_small.prepare(*b2w, q)
                 for q in (True, False)})
    tc2 = conv_block_pair.pick_tc_pair(t2, 16, 128, True)
    routed1 = {"routed_conv_block1_pair": lambda: (
        conv_block1_pair.fused_block1_pair(x1, *b1w,
                                           prepared=prep["b1", "conv1"]))}
    routed2 = {"routed_conv_block_pair": lambda: (
        conv_block_pair.fused_block2_pair(y1, *b2w, quantize=True, tc=tc2,
                                          prepared=prep["b2", True]))}

    def both(kern, plain, **kw):
        # (kernel, plain) in int8 and in the bf16 mode
        return dict(kernel=lambda: kern(True), plain=lambda: plain(True),
                    bf16=(lambda: kern(False), lambda: plain(False)), **kw)

    mk = 2.0 * clips * 64 * 576 * 64          # block 1's conv2 per frame
    pos2 = clips * t2 * 32
    b1_in = x1.numel() * 2 + _wbytes(b1w)
    b2_in = y1.numel() * 2 + _wbytes(b2w)
    b1_ops = {"int8": 2.0 * clips * t1 * 64 * 9 * 64 + mk * (t1 // 2 * 2)}
    b2_ops = {"int8": 2.0 * pos2 * 576 * 128 + 2.0 * pos2 * 1152 * 128}

    def pair(run, plain, name, w, x16, with_row3=None, **kw):
        # row 5: the second design (the route) held to its plain version
        # and the first, both timed in turns (beside row 3 on the same
        # input for the full block) and traced by launch
        fns = {(d, q): functools.partial(run, fn, q) for q in (True, False)
               for d, fn in (
                   ("v2", pair_conv_pool.fused_pair_conv_pool),
                   ("v1", pair_conv_pool._fused_pair_conv_pool_v1))}
        return _design(
            kernel=fns["v2", True], plain=lambda: plain(True),
            bf16=(fns["v2", False], lambda: plain(False)),
            check=_held_to_v1(fns["v1", True], name),
            source="pair_conv_pool_v2.cu", replaces="conv_block.py:691",
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (pair_conv_pool.cu)",
            trace=True, designs=lambda: _redesigned(
                fns, PAIR_KERNELS[name], lambda: plain(False),
                _block_chain(w, (2, 2)), x16, with_direct9=with_row3,
                beside="row3"),
            v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                      "pair_conv_pool.cu", **kw)

    # row 7: the second design (the route) held to its plain version and
    # the first; both timed in turns beside row 2's all-int8 / bf16 modes
    tc7 = block1_small.default_tc(t1)
    b1s = {(d, q): functools.partial(fn, x1, *b1w, quantize=q,
                                     prepared=prep["b1s", q])
           for q in (True, False)
           for d, fn in (("v2", block1_small.fused_block1),
                         ("v1", block1_small._fused_block1_v1))}

    def b1s_plain(q):
        return block1_small.block1_small_plain(x1, *b1w, quantize=q, tc=tc7)

    row2_modes = {q: functools.partial(
        conv_block1_pair.fused_block1_pair, x1, *b1w, quantize=q, tc=48,
        prepared=prep["b1", q]) for q in (True, False)}

    # row 6: row 3's second design at row 6's chunk and divided weights,
    # held to the plain version and to row 3's first design there, also at
    # odd T (a ragged last chunk at tc 2)
    tc6 = block2_small.default_tc(t2)
    b2s = {("v2", q): functools.partial(block2_small.fused_block2, y1, *b2w,
                                        quantize=q, prepared=prep["b2s", q])
           for q in (True, False)}
    b2s.update({("v1", q): functools.partial(
        conv_block_pair._launch_v1, y1, prep["b2s", q], q, tc6)
        for q in (True, False)})

    def b2s_plain(x, q, tc):
        return conv_block_pair.block2_plain(x, *b2w, quantize=q, tc=tc,
                                            divide=True)

    def row6_check(out, target):
        errs = _held_to_v1(b2s["v1", True], "block2_small")(out, target)
        odd = y1[:4, :499].contiguous()
        tco = block2_small.default_tc(odd.shape[1])
        got = block2_small.fused_block2(odd, *b2w, prepared=prep["b2s", True])
        vs_plain = _err(got, b2s_plain(odd, True, tco))[0]
        vs_v1 = _err(got, conv_block_pair._launch_v1(
            odd, prep["b2s", True], True, tco))[0]
        if tco != 2 or vs_plain or vs_v1:
            raise AssertionError(f"block2_small at T = 499 (tc {tco}): "
                                 f"max_abs {vs_plain} to its plain version, "
                                 f"{vs_v1} to the first design")
        return {**errs, "odd_t": {"shape": list(odd.shape), "tc": tco,
                                  "max_abs_err": vs_plain,
                                  "v1_max_abs_err": vs_v1}}

    def row2(mode, line):
        def first():
            return conv_block1_pair._fused_block1_pair_v1(
                x1, *b1w, quantize=True, tc=48, mode=mode,
                prepared=prep["b1", True])

        def check(out, target):
            # bit for bit to the plain version and to the first design
            errs = _bit_exact(out, target)
            vs_v1 = _err(out, first())[0]
            if vs_v1 != 0.0:
                raise AssertionError(f"differs from the first design: "
                                     f"max_abs {vs_v1}")
            return {**errs, "v1_max_abs_err": vs_v1}

        return _design(**both(
            lambda q: conv_block1_pair.fused_block1_pair(
                x1, *b1w, quantize=q, tc=48, mode=mode,
                prepared=prep["b1", q]),
            lambda q: conv_block1_pair.block1_plain(
                x1, *b1w, quantize=q, tc=48, mode=mode),
            ref=f32_1, ops=b1_ops, in_bytes=b1_in,
            source="conv_block1_v2.cu", check=check,
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (conv_block1_pair.cu)",
            replaces=f"conv_block1_pair.py:{line}", beside=routed1,
            timed={"v1": first}, input_shape=list(x1.shape)))

    return {
        "conv_block1_pair_int8": row2("triple", 346),
        "conv_block1_pair_single": row2("single", 239),
        "block1_small": _design(
            kernel=b1s["v2", True], plain=lambda: b1s_plain(True),
            bf16=(b1s["v2", False], lambda: b1s_plain(False)),
            check=_held_to_v1(b1s["v1", True], "block1_small"),
            ref=f32_1, ops={"bf16": 2.0 * clips * t1 * 64 * 9 * 64,
                            "int8": mk * (t1 // 2 * 2)},
            in_bytes=b1_in, source="block1_small_v2.cu",
            replaces="conv_block_small.py:471", beside=routed1,
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (block1_small.cu)",
            trace=True, designs=lambda: _redesigned(
                b1s, BLOCK1_KERNELS, lambda: b1s_plain(False),
                _block_chain(b1w, (2, 2)), x1[..., None],
                with_direct9=row2_modes, beside="row2"),
            input_shape=list(x1.shape), tc=block1_small.default_tc(t1),
            v1_source="texttoaudiogrounding_tpu_torch/csrc/block1_small.cu"),
        "pair_conv_pool_conv2": pair(
            lambda design, q: design(
                aq if q else a16, None, None, w2, ab2, quantize=q,
                x_scale=xs if q else None, prepared=prep["c2", q]),
            lambda q: pair_conv_pool.pair_conv_pool_plain(
                aq if q else a16, None, None, w2, ab2, quantize=q,
                tc=pair_conv_pool.pick_tc(tp, 32, 2),
                x_scale=xs if q else None),
            "pair_conv_pool_conv2", (None, None, w2, ab2), a16,
            ref=f32_1, ops={"int8": mk * tp},
            in_bytes=aq.numel() + 4 * (w2.numel() + 2 * 64),
            beside=routed1, input_shape=list(aq.shape)),
        "block2_small": _design(
            kernel=b2s["v2", True], plain=lambda: b2s_plain(y1, True, tc6),
            bf16=(b2s["v2", False], lambda: b2s_plain(y1, False, tc6)),
            check=row6_check, ref=f32_2, ops=b2_ops, in_bytes=b2_in,
            source="conv_block_v2.cu", replaces="conv_block_small.py:291",
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (conv_block_pair.cu at row 6's chunk and "
                      "weights), also at odd T (4 clips x 499 frames, tc 2)",
            trace=True, designs=lambda: _redesigned(
                b2s, ROW6_KERNELS, lambda: b2s_plain(y1, False, tc6),
                _block_chain(b2w, (2, 2)), y1),
            beside=routed2, input_shape=list(y1.shape), tc=tc6,
            v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                      "conv_block_pair.cu"),
        "pair_conv_pool": pair(
            lambda design, q: design(y1, *b2w, quantize=q,
                                     prepared=prep["b2", q]),
            lambda q: pair_conv_pool.pair_conv_pool_plain(
                y1, *b2w, quantize=q, tc=pair_conv_pool.pick_tc(t2, 16, 2)),
            "pair_conv_pool", b2w, y1, ref=f32_2, ops=b2_ops,
            in_bytes=b2_in, beside=routed2, input_shape=list(y1.shape),
            with_row3={q: lambda q=q: conv_block_pair.fused_block2_pair(
                y1, *b2w, quantize=q, tc=tc2 if q else None,
                prepared=prep["b2", q]) for q in (True, False)}),
    }


# row 7's kernels a call: second design (int8: the max pass, the quantize
# pass, conv2; bf16: conv1 and conv2), first design (int8: the im2col's five
# PyTorch kernels, conv1, the requantize pass, conv2; bf16 without the
# requantize pass)
BLOCK1_KERNELS = {("v2", True): 3, ("v2", False): 2, ("v1", True): 8,
                  ("v1", False): 7}
# row 6's: row 3's designs (second: the x window maxes, the quantize pass,
# conv1, the y1 requantization, conv2; bf16 the pad pass and the two
# convs; first: the gather, conv1, the requantization, conv2; bf16 the
# gather and the two convs)
ROW6_KERNELS = {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
                ("v1", False): 3}
# row 5's kernels a call: second design (int8: the x window maxes, the
# quantize pass, conv1, the y1 requantization, conv2; bf16: the pad pass
# and the two convs; conv2 alone one GEMM), first design (int8: the
# gather, conv1, the y1 requantization, conv2; bf16: the gather and the
# two convs; conv2 alone one)
PAIR_KERNELS = {
    "pair_conv_pool": {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
                       ("v1", False): 3},
    "pair_conv_pool_conv2": {("v2", True): 1, ("v2", False): 1,
                             ("v1", True): 1, ("v1", False): 1}}


def _single_loud_frame(x1, b1w) -> dict:
    """Row 2's single staging on 4 clips of x1 made quiet, with one loud
    frame at t = 98: y1 at t = 97 lies in chunk 1's single window [46, 97]
    (tc = 48) and not in the triple window [47, 96], and it sets the
    chunk's y1 scale.  The kernel must equal its plain version bit for bit
    and differ from the triple staging's kernel."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair

    x = (x1[:4].float() * 0.05)
    x[:, 98] = 5.0
    x = x.to(x1.dtype).contiguous()
    single = conv_block1_pair.fused_block1_pair(x, *b1w, quantize=True,
                                                mode="single")
    plain = conv_block1_pair.block1_plain(x, *b1w, quantize=True,
                                          mode="single")
    triple = conv_block1_pair.fused_block1_pair(x, *b1w, quantize=True)
    max_abs = _err(single, plain)[0]
    vs_triple = _err(single, triple)[1]
    if max_abs != 0.0 or vs_triple < 1e-3:
        raise AssertionError(f"row 2 single, loud frame: max_abs to its "
                             f"plain version {max_abs} (must be 0), "
                             f"relative RMS to the triple staging "
                             f"{vs_triple} (must reach 1e-3)")
    return {"max_abs_err": max_abs, "rel_rms_vs_triple": vs_triple}


def _log_mel_f64(wave, cfg):
    """The log-mel in float64 (reflect-padded frames, the windowed DFT,
    the slaney mel), the reference of the log-mel rows."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops import frontend
    frames = frontend.frame_waveform(wave.double(), cfg)
    basis = torch.from_numpy(frontend._dft_kernel(cfg)).to(wave.device)
    spec = torch.matmul(frames, basis.double())
    nf = cfg.n_freqs
    power = spec[..., :nf] ** 2 + spec[..., nf:] ** 2
    fb = torch.from_numpy(frontend.mel_filterbank(cfg)).to(wave.device)
    mel = torch.matmul(power, fb.double())
    return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))


def _block_chain(w, pool):
    """A block's bf16 mode as a PyTorch chain on ``[B, T, M, C]``: cuDNN
    bf16 ``F.conv2d``, the BN affine and ReLU, again, then ``avg_pool2d +
    max_pool2d`` at ``pool``; a yardstick that the port never calls.
    With ``w1`` None (``w = (None, None, w2, ab2)``) conv2 alone."""
    import torch
    import torch.nn.functional as F
    w1, ab1, w2, ab2 = w
    k2 = w2.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    aff = [(a.to(torch.bfloat16)[:, None, None], b.to(torch.bfloat16)[
        :, None, None]) for a, b in (ab1 or ab2, ab2)]
    if w1 is not None:
        k1 = w1.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()

    def chain(x):
        y = x.permute(0, 3, 1, 2)
        if w1 is not None:
            y = F.conv2d(y, k1, padding=1)
            y = torch.relu(y * aff[0][0] + aff[0][1])
        y = F.conv2d(y, k2, padding=1)
        y = torch.relu(y * aff[1][0] + aff[1][1])
        return (F.avg_pool2d(y, pool) + F.max_pool2d(y, pool)).permute(
            0, 2, 3, 1)
    chain.label = (f"cuDNN bf16 F.conv2d -> affine -> ReLU"
                   f"{'' if w1 is None else ', twice'} -> avg_pool2d + "
                   f"max_pool2d")
    return chain


def _kernel_launches(trace: dict) -> int:
    """The kernels of a by-launch trace (memsets and copies left out)."""
    return sum(1 for e in trace["by_launch"]
               if not e["kernel"].startswith(("Memset", "Memcpy")))


def _redesigned(fns: dict, launches: dict, plain16, chain, x,
                with_direct9=None, beside: str = "direct9") -> dict:
    """A redesigned row's two designs ``fns`` {(design, int8?): fn}: timed
    in turns (v1 v2 v2 v1, with ``with_direct9`` {int8?: fn}, the kernel
    named ``beside``, as v1 v2 d9 d9 v2 v1) in int8 and bf16; each traced
    by launch, its kernels a call counted by the profiler and held to
    ``launches`` {(design, int8?): n}; the first design's bf16 mode held
    within 1e-2 relative RMS of its plain version ``plain16()``; and the
    cuDNN bf16 chain on ``x``."""
    out, counts = {}, {}
    for q, key in ((True, ""), (False, "bf16_")):
        fq = {d: fns[d, q] for d in ("v1", "v2")}
        order = ("v1", "v2")
        if with_direct9:
            fq[beside], order = with_direct9[q], ("v1", "v2", beside)
        t = _turns(fq, order)
        out.update({f"{key}ms": t["v2"], f"v1_{key}ms": t["v1"],
                    f"{key}turns_ms": t["runs"]})
        if with_direct9:
            out[f"{beside}_{key}turns_mean_ms"] = t[beside]
        for d in ("v2", "v1"):
            tr = _trace(fq[d], t[d], by_launch=True)
            out[f"{d}_{key}trace"] = tr
            counts[f"{d}_{key or 'int8_'}kernels"] = _kernel_launches(tr)
            counts[f"{d}_{key or 'int8_'}device_events"] = tr["launches"]
    want = {f"{d}_{'int8_' if q else 'bf16_'}kernels": n
            for (d, q), n in launches.items()}
    got = {k: v for k, v in counts.items() if k.endswith("kernels")}
    if got != want:
        raise AssertionError(f"kernels a call {got}, expected {want}")
    v1_16 = _err(fns["v1", False](), plain16())[1]
    if v1_16 > 1e-2:
        raise AssertionError(f"the first design's bf16 mode: rel_rms "
                             f"{v1_16} to its plain version > 0.01")
    return {**out, "launches_per_call": counts,
            "v1_bf16_rel_rms_err": v1_16,
            "chain_ms": _cuda_ms(lambda: chain(x), 10),
            "chain": chain.label,
            "chain_rel_rms_vs_bf16_plain": _err(chain(x), plain16())[1]}


def _held_to_v1(first, name: str):
    """A check of the counted run against its plain version (bit for bit),
    the first design ``first()`` against both (int8)."""
    def check(out, target):
        v1 = first()
        vs_v1, v1_plain = _err(out, v1)[0], _err(v1, target)[0]
        if vs_v1 or v1_plain:
            raise AssertionError(f"{name}: the first design differs from "
                                 f"the second ({vs_v1}) or from the plain "
                                 f"version ({v1_plain})")
        return {**_bit_exact(out, target), "v1_max_abs_err": vs_v1,
                "v1_vs_plain_max_abs_err": v1_plain}
    return check


# row 8 at the pool-(2, 2) analog of blocks 3-4 (scripts/bench_wino.py):
# (block, Cin, Cout, the bf16 chunk where the JAX rule finds none)
WINO_BLOCKS = ((3, 128, 256, None), (4, 256, 512, 14))
# kernels a call: second design (int8: a scale pass, the V_k pass and the
# product kernel a conv; bf16 the last two), first design (transform,
# products, output transform a conv)
WINO_KERNELS = {("v2", True): 6, ("v2", False): 4, ("v1", True): 6,
                ("v1", False): 6}


def _wino_designs(enc, y2) -> tuple:
    """Row 8 through ``ConvBlock(..., wino=True)`` in int8, with the served
    blocks 3-4 weights, at the pool-(2, 2) analog of blocks 3-4: on the
    served block-2 output (block 3, 128 -> 256) and on that result (block 4,
    256 -> 512); one record per block, on its second design
    (``conv_block_wino_v2.cu``), held bit for bit to its plain version and
    to the first design (``conv_block_wino.cu``, itself held to the plain
    version), both timed in turns in int8 and bf16 and traced by launch,
    beside the direct9 kernel (row 4) at pool (2, 2) on the same input and
    the cuDNN bf16 chain.  Bound by the Winograd products' operations (16
    per 2 x 2 output tile and conv), the least the function needs: its
    int8 result is fixed by the per-(k, chunk) scales of V_k, which a
    direct conv does not have; the direct conv's count, the yardstick of
    rows 2-7, is printed beside it, and the byte floor of the design (x,
    V_k and y1 written and read, the output).  Returns (records, the
    route's outputs)."""
    import torch

    from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        conv_block, conv_block_wino)

    records, outs, x = {}, {}, y2
    for i, cin, cout, tc16 in WINO_BLOCKS:
        name = f"conv_block_wino_block{i}"
        blk = ConvBlock(cin, cout, "int8", wino=True).to(DEVICE).eval()
        blk.load_state_dict(getattr(enc, f"conv_block{i}").state_dict())
        with torch.no_grad():
            outs[name] = blk(x, (2, 2))
            f32 = getattr(enc, f"conv_block{i}")._plain(x.float(), (2, 2))
        w = _block_weights(blk)
        b, t, m, _ = x.shape
        tpad, tc = conv_block_wino.pick_tpad_tc(t, m, cin, cout, True)
        tpad16, tc16 = conv_block_wino.chunking(t, m, cin, cout, False, tc16)
        wq, w16 = (conv_block_wino.wino_weights(*w, q) for q in (True, False))
        dq, d16 = (conv_block.kernel_weights(*w, q) for q in (True, False))
        pos = b * t * m
        direct_ops = 2.0 * pos * 9 * (cin * cout + cout * cout)
        wino_ops = 2.0 * (pos // 4) * 16 * (cin * cout + cout * cout)
        in_bytes = x.numel() * 2 + _wbytes(w)
        nbytes = in_bytes + outs[name].numel() * 2
        g, mp = b * tpad // tc, m // 2
        tiles = g * (tc // 2 + 2) * mp, g * tc // 2 * mp
        y1_bytes = g * (tc + 4) * m * cout * 2
        v_bytes = 16 * (tiles[0] * cin + tiles[1] * cout)   # int8
        fns = {
            ("v2", True): lambda x=x, w=w, p=wq: (
                conv_block_wino.fused_block_wino(x, *w, quantize=True,
                                                 prepared=p)),
            ("v1", True): lambda x=x, w=w, p=wq: (
                conv_block_wino._fused_block_wino_v1(x, *w, quantize=True,
                                                     prepared=p)),
            ("v2", False): lambda x=x, w=w, tc=tc16, p=w16: (
                conv_block_wino.fused_block_wino(x, *w, tc=tc, prepared=p)),
            ("v1", False): lambda x=x, w=w, tc=tc16, p=w16: (
                conv_block_wino._fused_block_wino_v1(x, *w, tc=tc,
                                                     prepared=p))}
        plain16 = (lambda x=x, w=w, tc=tc16, tp=tpad16, p=w16:
                   conv_block_wino.block_wino_plain(
                       x, *w, quantize=False, tc=tc, tpad=tp, prepared=p))
        records[name] = _design(
            kernel=fns["v2", True],
            plain=lambda x=x, w=w, tc=tc, tp=tpad, p=wq: (
                conv_block_wino.block_wino_plain(
                    x, *w, quantize=True, tc=tc, tpad=tp, prepared=p)),
            check=_held_to_v1(fns["v1", True], name),
            bf16=(fns["v2", False], plain16),
            ref=("f32_block", f32), ops={"int8": wino_ops},
            in_bytes=in_bytes, source="conv_block_wino_v2.cu",
            replaces="conv_block_wino.py:264", counter="conv_block_wino",
            beside={
                "direct9": lambda x=x, w=w, p=dq: (
                    conv_block.fused_double_conv_pool(
                        x, *w, (2, 2), quantize=True, prepared=p)),
                "direct9_bf16": lambda x=x, w=w, p=d16: (
                    conv_block.fused_double_conv_pool(x, *w, (2, 2),
                                                      prepared=p))},
            timed={"weights": lambda w=w: conv_block_wino.wino_weights(
                *w, True)},
            trace=True,
            designs=lambda fns=fns, plain16=plain16, x=x, w=w: _redesigned(
                fns, WINO_KERNELS, plain16, _block_chain(w, (2, 2)), x),
            input_shape=list(x.shape), cin=cin, cout=cout,
            tc=tc, tpad=tpad, bf16_tc=tc16, winograd_ops=wino_ops,
            direct_ops=direct_ops,
            direct_bound_ms=_bound(nbytes, {"int8": direct_ops})[0],
            direct_bf16_bound_ms=_bound(nbytes, {"bf16": direct_ops})[0],
            byte_floor_ms=(nbytes + 2 * y1_bytes + 2 * v_bytes) / HBM * 1e3,
            v_bytes=v_bytes, y1_bytes=y1_bytes,
            v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                      "conv_block_wino.cu")
        x = outs[name]
    return records, outs


# row 4's tap modes at the flagship's blocks 3-4, pool (1, 2): (block,
# Cin, Cout)
SLAB_BLOCKS = ((3, 128, 256), (4, 256, 512))
# kernels a call: second designs (int8: the x maxes, the quantize pass,
# conv1, the y1 requantization, conv2; bf16: the pad pass and the two
# convs), first design (int8: the quantize pass, conv1, the y1
# requantization, conv2; bf16 the two convs, mel3 after a gather pass)
SLAB_KERNELS = {
    "tri": {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
            ("v1", False): 2},
    "mel3": {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
             ("v1", False): 3}}


def _slab_designs(enc, y2) -> tuple:
    """Row 4's mel3 and tri modes, each (True, True), with the served
    blocks 3-4 weights at the flagship's pool (1, 2): on the served block-2
    output (block 3) and on the mode's own block-3 output (block 4); one
    record per mode and block, int8 at the mode's own JAX chunk and its
    bf16 mode at its own, beside direct9 (row 4) on the same input, each
    with its weights laid out once.  Both run their second designs, the
    wgmma GEMM's slab form (``conv_block_mel3_v2.cu``,
    ``conv_block_tri_v2.cu``), held bit for bit to the plain version and
    to the first design (the slab kernel of ``conv_block_mel3.cu``, itself
    held to the plain version); tri also to direct9 at tri's chunk and at
    direct9's own (its scales are direct9's); mel3 also in its (True,
    False) mode, and in bf16 bit for bit to tri (the same function at the
    same chunk); the designs timed in turns beside direct9 at the mode's
    chunk and traced by launch, beside the cuDNN bf16 chain.  Bound by the
    direct conv's operations, all of which both do.  Returns (records, the
    outputs of the counted run)."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as cb

    records, outs = {}, {}
    for mode in ("mel3", "tri"):
        x = y2
        for i, cin, cout in SLAB_BLOCKS:
            name = f"conv_block_{mode}_block{i}"
            blk = getattr(enc, f"conv_block{i}")
            w = _block_weights(blk)
            kw = {mode: (True, True)}
            pq, p16 = (cb.kernel_weights(*w, q) for q in (True, False))
            modes = {q: cb.tap_modes(cin, q, **kw) for q in (True, False)}
            tcs = {q: cb.block_tc(x.shape, cout, (1, 2), q, modes[q])
                   for q in (True, False)}
            d9_tc = {q: cb.block_tc(x.shape, cout, (1, 2), q, (False,) * 4)
                     for q in (True, False)}
            outs[name] = cb.fused_double_conv_pool(
                x, *w, (1, 2), quantize=True, prepared=pq, **kw)
            with torch.no_grad():
                f32 = blk._plain(x.float(), (1, 2))
            b, t, m, _ = x.shape
            ops = 2.0 * b * t * m * 9 * (cin * cout + cout * cout)

            def run(q, x=x, w=w, kw=kw, pq=pq, p16=p16, **over):
                return cb.fused_double_conv_pool(
                    x, *w, (1, 2), quantize=q, prepared=pq if q else p16,
                    **{**kw, **over})

            def plain(q, x=x, w=w, modes=modes, tcs=tcs):
                return cb.block_plain(x, *w, (1, 2), quantize=q, tc=tcs[q],
                                      modes=modes[q])

            first_fn = {"mel3": cb._fused_mel3_v1,
                        "tri": cb._fused_tri_v1}[mode]

            def first(q, x=x, w=w, pq=pq, p16=p16, first_fn=first_fn,
                      **over):
                return first_fn(x, *w, (1, 2), quantize=q,
                                prepared=pq if q else p16, **over)

            if mode == "tri":
                def check(out, target, run=run, tc=d9_tc[True],
                          tri_tc=tcs[True], name=name, first=first):
                    errs = _held_to_v1(lambda: first(True), name)(out,
                                                                  target)
                    same_tc = _err(out, run(True, tri=None, tc=tri_tc))[0]
                    got = run(True, tc=tc)
                    same = _err(got, run(True, tri=None, tc=tc))[0]
                    if same or same_tc:
                        raise AssertionError(
                            f"{name}: tri differs from the row-4 kernel at "
                            f"tri's tc {tri_tc} ({same_tc}) or at direct9's "
                            f"tc {tc} ({same})")
                    return {**errs, "vs_direct9_at_tri_tc_max_abs": same_tc,
                            "vs_direct9_at_its_tc_max_abs": same}
            else:
                def check(out, target, run=run, name=name, first=first,
                          x=x, w=w, cin=cin, cout=cout):
                    errs = _held_to_v1(lambda: first(True), name)(out,
                                                                  target)
                    # (True, False): f32 y1 and direct9's conv2
                    tf = cb.tap_modes(cin, True, (True, False))
                    got = run(True, mel3=(True, False))
                    tf_plain = _err(got, cb.block_plain(
                        x, *w, (1, 2), quantize=True, modes=tf,
                        tc=cb.block_tc(x.shape, cout, (1, 2), True, tf)))[0]
                    tf_v1 = _err(got, first(True, mel3=(True, False)))[0]
                    # bf16: tri's function at tri's chunk, tri's launches
                    vs_tri = _err(run(False), run(False, mel3=None,
                                                  tri=(True, True)))[0]
                    if tf_plain or tf_v1 or vs_tri:
                        raise AssertionError(
                            f"{name}: mel3 (True, False) differs from its "
                            f"plain version ({tf_plain}) or first design "
                            f"({tf_v1}), or bf16 mel3 from bf16 tri "
                            f"({vs_tri})")
                    return {**errs, "tf_max_abs_err": tf_plain,
                            "tf_v1_max_abs_err": tf_v1,
                            "bf16_vs_tri_max_abs": vs_tri}
            fns = {(d, q): (lambda run=run, q=q: run(q)) if d == "v2"
                   else (lambda first=first, q=q: first(q))
                   for d in ("v2", "v1") for q in (True, False)}
            d9 = {q: (lambda run=run, q=q, tc=tcs[q]: run(
                q, mel3=None, tri=None, tc=tc)) for q in (True, False)}
            records[name] = _design(
                kernel=lambda run=run: run(True),
                plain=lambda plain=plain: plain(True),
                bf16=(lambda run=run: run(False),
                      lambda plain=plain: plain(False)),
                ref=("f32_block", f32), ops={"int8": ops},
                in_bytes=x.numel() * 2 + _wbytes(w),
                source=f"conv_block_{mode}_v2.cu",
                replaces="conv_block.py:370",
                counter=f"conv_block_{mode}", check=check,
                beside={"direct9": lambda run=run: run(True, mel3=None,
                                                       tri=None),
                        "direct9_bf16": lambda run=run: run(
                            False, mel3=None, tri=None)},
                trace=True, input_shape=list(x.shape), cin=cin, cout=cout,
                mode=f"{mode}=(True, True)", tc=tcs[True],
                bf16_tc=tcs[False], direct9_tc=d9_tc[True],
                direct9_bf16_tc=d9_tc[False],
                designs=lambda fns=fns, plain=plain, x=x, w=w, d9=d9,
                kernels=SLAB_KERNELS[mode]: _redesigned(
                    fns, kernels, lambda: plain(False),
                    _block_chain(w, (1, 2)), x, with_direct9=d9),
                v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                          "conv_block_mel3.cu")
            x = outs[name]
    return records, outs


def _v3_check(wave, cfg, t_lo: int, t_hi: int):
    """Row 9's check: within V3_MAX_DB max and V3_MEAN_DB mean of its plain
    version, while row 1's first design (f32 mel; the tile code row 9
    shares) on the interior frames must miss those limits (the control:
    they tell the two projections apart)."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel

    def check(out, plain) -> dict:
        d = (out - plain).abs()
        row1 = logmel._fused_log_mel_spectrogram_v1(wave, cfg)
        ctl = (row1 - plain)[:, t_lo:t_hi].abs()
        got = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
               "rel_rms_err": _err(out, plain)[1],
               "control_row1_max_abs_err": float(ctl.max()),
               "control_row1_mean_abs_err": float(ctl.mean())}
        if got["max_abs_err"] > V3_MAX_DB or got["mean_abs_err"] > V3_MEAN_DB:
            raise AssertionError(f"off its plain version: {got}")
        if (got["control_row1_max_abs_err"] <= V3_MAX_DB
                and got["control_row1_mean_abs_err"] <= V3_MEAN_DB):
            raise AssertionError(f"row 1's kernel meets v3's limits, which "
                                 f"so do not hold its bf16 mel: {got}")
        return got
    return check


# row 9's kernels a call: the second design's cast pass and its one launch
# of tiles and edge blocks
V3_KERNELS = 2
V3_EDGE_DB = 2e-3     # the edge frames against _edge_frames (f32 sums)


def _v3_designs(wave, cfg, t_lo: int, t_hi: int, row1: dict) -> dict:
    """Row 9's two designs timed in turns beside row 1 (v1 v2 row1 row1 v2
    v1), each traced by launch (the second must make V3_KERNELS kernels a
    call), the first design held by :func:`_v3_check` too, and the
    ``torch.stft`` chain beside."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel_v3

    fns = {"v1": lambda: logmel_v3._fused_log_mel_spectrogram_v3_v1(wave,
                                                                   cfg),
           "v2": lambda: logmel_v3.fused_log_mel_spectrogram_v3(wave, cfg),
           "row1": row1["row1"]}
    t = _turns(fns, ("v1", "v2", "row1"))
    traces = {f"{d}_trace": _trace(fns[d], t[d], by_launch=True)
              for d in ("v2", "v1")}
    kernels = {d: _kernel_launches(traces[f"{d}_trace"]) for d in ("v2", "v1")}
    if kernels["v2"] != V3_KERNELS:
        raise AssertionError(f"logmel_v3: {kernels['v2']} kernels a call, "
                             f"expected {V3_KERNELS}")
    first = fns["v1"]()
    v1_errs = _v3_check(wave, cfg, t_lo, t_hi)(
        first, logmel_v3.log_mel_v3_plain(wave, cfg))
    chain = _logmel_chain(cfg, wave.device)
    return {"ms": t["v2"], "v1_ms": t["v1"], "row1_turns_mean_ms": t["row1"],
            "turns_ms": t["runs"], "kernels_per_call": kernels,
            "v1_max_abs_err": v1_errs["max_abs_err"],
            "v1_mean_abs_err": v1_errs["mean_abs_err"],
            "v2_vs_v1_max_abs": _err(fns["v2"](), first)[0],
            "chain_ms": _cuda_ms(lambda: chain(wave), 10),
            "chain": "torch.stft (cuFFT) -> power -> @ fb -> dB, f32",
            "v1_source": "texttoaudiogrounding_tpu_torch/csrc/logmel_v3.cu",
            **traces}


# row 10's kernels a call: the second design's pad pass and its persistent
# kernel
V4_KERNELS = 2


def _v4_designs(wave, cfg, row1: dict) -> dict:
    """Row 10's two designs timed in turns beside row 1 (v1 v2 row1 row1
    v2 v1), each traced by launch (the second must make V4_KERNELS kernels
    a call), the first design held bit for bit to row 1's first design
    (``csrc/logmel.cu``, whose tile code it shares), and the
    ``torch.stft`` chain beside."""
    from texttoaudiogrounding_tpu_torch.ops import frontend
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel, logmel_v4

    fns = {"v1": lambda: logmel_v4._fused_log_mel_spectrogram_v4_v1(wave,
                                                                   cfg),
           "v2": lambda: logmel_v4.fused_log_mel_spectrogram_v4(wave, cfg),
           "row1": row1["row1"]}
    t = _turns(fns, ("v1", "v2", "row1"))
    traces = {f"{d}_trace": _trace(fns[d], t[d], by_launch=True)
              for d in ("v2", "v1")}
    kernels = {d: _kernel_launches(traces[f"{d}_trace"]) for d in ("v2", "v1")}
    if kernels["v2"] != V4_KERNELS:
        raise AssertionError(f"logmel_v4: {kernels['v2']} kernels a call, "
                             f"expected {V4_KERNELS}")
    first = fns["v1"]()
    v1_vs_row1 = _err(first, row1["row1_v1"]())[0]
    if v1_vs_row1 != 0.0:
        raise AssertionError(f"logmel_v4's first design differs from row "
                             f"1's first design: max_abs {v1_vs_row1}")
    b, n = wave.shape
    tiles = b * -(-frontend.num_frames(n, cfg.hop_length) // logmel._TILE_V2)
    chain = _logmel_chain(cfg, wave.device)
    return {"ms": t["v2"], "v1_ms": t["v1"], "row1_turns_mean_ms": t["row1"],
            "turns_ms": t["runs"], "kernels_per_call": kernels,
            "v1_max_abs_vs_row1_v1": v1_vs_row1,
            "v2_vs_v1_max_abs": _err(fns["v2"](), first)[0],
            "tiles": tiles,
            "persistent_blocks": logmel_v4._grid(wave.device, tiles),
            "chain_ms": _cuda_ms(lambda: chain(wave), 10),
            "chain": "torch.stft (cuFFT) -> power -> @ fb -> dB, f32",
            "v1_source": "texttoaudiogrounding_tpu_torch/csrc/logmel_v4.cu",
            **traces}


def _logmel_designs(wave) -> tuple:
    """Rows 9 and 10 once on the served waveform, beside row 1's two
    designs: v3 on its second design (``logmel_v3_v2.cu``) held by
    :func:`_v3_check`, its edge frames within V3_EDGE_DB of the plain
    frontend's (``_edge_frames``), timed in turns with its first design
    (``logmel_v3.cu``) beside row 1; v4 on its second design
    (``logmel_v4_v2.cu``) bit for bit to row 1's second design
    (``csrc/logmel_v2.cu``), timed in turns with its first design by
    :func:`_v4_designs`; each compared with the f64 log-mel.  Returns
    (records, outputs)."""
    from texttoaudiogrounding_tpu_torch.ops import frontend
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        logmel, logmel_v3, logmel_v4)

    cfg = frontend.cnn8rnn_mel_config(SR)
    outs = {"logmel_v3": logmel_v3.fused_log_mel_spectrogram_v3(wave, cfg),
            "logmel_v4": logmel_v4.fused_log_mel_spectrogram_v4(wave, cfg)}
    b, n = wave.shape
    t = outs["logmel_v3"].shape[1]
    t_lo, t_hi = logmel_v3.edges(n, cfg)
    frames = b * (t_hi - t_lo)
    ref = ("f64", _log_mel_f64(wave, cfg))
    row1 = {"row1_v1": lambda: logmel._fused_log_mel_spectrogram_v1(wave,
                                                                     cfg),
            "row1": lambda: logmel.fused_log_mel_spectrogram(wave, cfg)}
    dft, _, mel = _logmel_ops(cfg, frames)        # v3: interior frames
    edge = _logmel_ops(cfg, b * (t - t_hi + t_lo))  # its f32 edge frames
    dft4, power4, mel4 = _logmel_ops(cfg, b * t)

    def v3_check(out, plain):
        errs = _v3_check(wave, cfg, t_lo, t_hi)(out, plain)
        left, right = logmel_v3._edge_frames(wave, cfg, t_lo, t_hi)
        got = max(float((out[:, :t_lo] - left).abs().max()),
                  float((out[:, t_hi:] - right).abs().max()))
        if got > V3_EDGE_DB:
            raise AssertionError(f"edge frames {got} dB off _edge_frames")
        return {**errs, "edge_max_abs_err": got}

    return {
        "logmel_v3": _design(
            kernel=lambda: logmel_v3.fused_log_mel_spectrogram_v3(wave, cfg),
            plain=lambda: logmel_v3.log_mel_v3_plain(wave, cfg), ref=ref,
            ops={"bf16": dft + mel, "f32": sum(edge)},
            in_bytes=wave.numel() * 4, source="logmel_v3_v2.cu",
            replaces="logmel.py:350", check=v3_check,
            tolerance=f"max_abs_db <= {V3_MAX_DB}, mean_abs_db <= "
                      f"{V3_MEAN_DB}; row 1's kernel must miss them; edge "
                      f"frames max_abs_db <= {V3_EDGE_DB} to _edge_frames",
            beside=row1, timed={"v1_edge_frames": lambda: (
                logmel_v3._edge_frames(wave, cfg, t_lo, t_hi))},
            designs=lambda: _v3_designs(wave, cfg, t_lo, t_hi, row1)),
        "logmel_v4": _design(
            kernel=lambda: logmel_v4.fused_log_mel_spectrogram_v4(wave, cfg),
            plain=lambda: logmel.log_mel_plain(wave, cfg), ref=ref,
            ops={"bf16": dft4, "f32": power4 + mel4},
            in_bytes=wave.numel() * 4, source="logmel_v4_v2.cu",
            replaces="logmel.py:175", target=row1["row1"],
            tolerance="bit for bit equal to row 1's second design; its "
                      "first design bit for bit equal to row 1's first",
            beside=row1, designs=lambda: _v4_designs(wave, cfg, row1)),
    }, outs


TRAIN_CLIPS, TRAIN_EPOCHS, TRAIN_STEPS, VAL_STEPS = 32, 2, 4, 2
_TONES = (400.0, 800.0, 1600.0, 3000.0, 240.0, 5000.0, 1200.0, 2200.0)


def _strong_config(exp_dir: str, **audio_args) -> dict:
    """``configs/strong/biencoder_train.yaml``'s model, loss, optimizer and
    trainer, with the epochs cut to ``TRAIN_EPOCHS`` of ``TRAIN_STEPS`` and
    ``audio_args`` added to ``audio_encoder.args``."""
    return {
        "experiment_path": exp_dir, "seed": 1,
        "model": {"type": "BiEncoder",
                  "args": {"shared_dim": 512, "add_proj": True},
                  "audio_encoder": {"type": "Cnn8Rnn",
                                    "args": {"sample_rate": SR,
                                             **audio_args}},
                  "text_encoder": {"type": "EmbeddingAgg",
                                   "args": {"vocab_size": 5000,
                                            "embed_dim": 512,
                                            "aggregation": "mean"}},
                  "match_fn": {"type": "ExpNegL2", "args": {}}},
        "loss": {"type": "FrameBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "factor": 0.1,
                                  "patience": 3}},
        "trainer": {"epochs": TRAIN_EPOCHS, "epoch_length": TRAIN_STEPS,
                    "early_stop": 10, "save_interval": 1,
                    "max_grad_norm": 1.0,
                    "metric_monitor": {"mode": "min", "name": "loss"},
                    "include_optim_in_ckpt": True},
    }


def _clip_items(count: int, seed: int):
    """A dataset of ``AudioPhraseDataset`` items made in memory: 10 s of
    noise with a tone over one labelled segment, the phrase naming the
    tone, the waveform stored in float16 as the packed HDF5 files are."""
    import numpy as np
    from torch.utils.data import Dataset

    from texttoaudiogrounding_tpu_torch.data.datasets import frame_labels

    class Items(Dataset):
        def __len__(self):
            return count

        def __getitem__(self, i):
            rng = np.random.default_rng((seed, i))
            n = SR * CLIP_S
            wav = rng.normal(0, 0.01, n).astype(np.float32)
            k = int(rng.integers(len(_TONES)))
            on = float(rng.uniform(0.05, 0.7)) * CLIP_S
            off = on + float(rng.uniform(0.05, 0.25)) * CLIP_S
            idx = np.arange(int(on * SR), int(off * SR))
            wav[idx] += 0.3 * np.sin(2 * np.pi * _TONES[k] * idx / SR)
            return {"audio_id": f"clip{i}", "audiocap_id": i,
                    "start_index": 0, "end_index": 1,
                    "waveform": wav.astype(np.float16),
                    "phrase": f"w{2 + k} w{20 + k}",
                    "caption": f"w{2 + k} w{20 + k}",
                    "label": frame_labels(n, [[on, off]], SR, 0.04)}

    return Items()


def _grads(model, batch, output_transform, loss_fn) -> dict:
    """Every parameter's gradient of one train-mode step on ``batch``."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss_fn(output_transform(model(batch), batch)).backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def _gaps(grads: dict, ref: dict) -> dict:
    """Relative RMS of each gradient to ``ref``'s."""
    import torch
    return {name: float(torch.sqrt(((grads[name] - r) ** 2).mean()
                                   / (r ** 2).mean().clamp_min(1e-30)))
            for name, r in ref.items()}


def _worst(gaps: dict) -> tuple:
    """(largest gap in the conv trunk, largest gap after it)."""
    trunk = [g for n, g in gaps.items() if "conv_block" in n or "bn0" in n]
    rest = [g for n, g in gaps.items()
            if not ("conv_block" in n or "bn0" in n)]
    return max(trunk), max(rest)


def _counter_modules() -> tuple:
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        block1_small, block2_small, bn_pool, conv_block, conv_block1_pair,
        conv_block_pair, conv_block_wino, dual_pool, gru, logmel, logmel_v3,
        logmel_v4, pair_conv_pool)
    return ({"logmel": logmel, "conv_block_pair": conv_block_pair,
             "conv_block_wino": conv_block_wino,
             "logmel_v3": logmel_v3, "logmel_v4": logmel_v4},
            (conv_block, conv_block1_pair, gru, dual_pool, bn_pool,
             pair_conv_pool, block2_small, block1_small))


def _counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name (the first
    designs of rows 1, 9, 10, 3 and 8 count in ``logmel.launches_v1``,
    ``logmel_v3.launches_v1``, ``logmel_v4.launches_v1``,
    ``conv_block_pair.launches_v1`` and ``conv_block_wino.launches_v1``)."""
    ints, dicts = _counter_modules()
    out = {name: mod.launches for name, mod in ints.items()}
    out["logmel_v1"] = ints["logmel"].launches_v1
    out["logmel_v3_v1"] = ints["logmel_v3"].launches_v1
    out["logmel_v4_v1"] = ints["logmel_v4"].launches_v1
    out["conv_block_pair_v1"] = ints["conv_block_pair"].launches_v1
    out["conv_block_wino_v1"] = ints["conv_block_wino"].launches_v1
    for mod in dicts:
        out.update(mod.launches)
    return out


def _reset_counts() -> None:
    ints, dicts = _counter_modules()
    for mod in ints.values():
        mod.launches = 0
    ints["logmel"].launches_v1 = 0
    ints["logmel_v3"].launches_v1 = 0
    ints["logmel_v4"].launches_v1 = 0
    ints["conv_block_pair"].launches_v1 = 0
    ints["conv_block_wino"].launches_v1 = 0
    for mod in dicts:
        for k in mod.launches:
            mod.launches[k] = 0


def _want(**nonzero) -> dict:
    return {k: nonzero.get(k, 0) for k in _counts()}


def _loaders(tok, seed: int) -> tuple:
    """(train, validation) loaders over the in-memory clips."""
    from texttoaudiogrounding_tpu_torch.data.collate import TextCollate
    from texttoaudiogrounding_tpu_torch.data.loader import build_loader

    collate = TextCollate(tok, text_key="phrase",
                          pad_keys=["waveform", "label"],
                          pad_buckets={"waveform": 32000, "label": 100},
                          text_bucket=4)
    train_items = _clip_items(TRAIN_CLIPS * TRAIN_STEPS * TRAIN_EPOCHS, 1)
    val_items = _clip_items(TRAIN_CLIPS * VAL_STEPS, 2)
    return (build_loader(train_items, collate, seed, batch_size=TRAIN_CLIPS,
                         shuffle=True, drop_last=True),
            build_loader(val_items, collate, seed, batch_size=TRAIN_CLIPS))


def training_phase(tok) -> dict:
    import tempfile

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    report: dict = {"clips_per_batch": TRAIN_CLIPS, "clip_s": CLIP_S,
                    "tf32": False}
    with tempfile.TemporaryDirectory(prefix="ttg_train_") as tmp:
        runner = StrongRunner(device=DEVICE)
        config = runner.setup(_strong_config(tmp))
        exp_dir = runner.prepare_experiment()
        train_loader, val_loader = _loaders(tok, config["seed"])
        model = runner.build_model()
        sd = random_state_dict(model, seed=1)
        model.load_state_dict(sd)
        loss_fn = runner.build_loss()

        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = runner.fit(model, loss_fn, train_loader, val_loader,
                            strong_output_transform, exp_dir)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _counts()
        steps = TRAIN_EPOCHS * TRAIN_STEPS
        want = _want(gru_fwd=steps + TRAIN_EPOCHS * VAL_STEPS, gru_bwd=steps)
        if launches != want:
            raise AssertionError(f"fit: kernel launches {launches}, "
                                 f"expected {want}")
        if not all(np.isfinite(record["step_loss"] + record["val_loss"])):
            raise AssertionError(f"fit: loss not finite {record}")
        for name in ("best.pth", "last.pth", "train.log"):
            if not (exp_dir / name).is_file():
                raise AssertionError(f"fit: {name} not written")
        report.update(fit_s=fit_s, fit_launches=launches,
                      fit_step_loss=record["step_loss"],
                      fit_val_loss=record["val_loss"])

    # gradients: kernel path against the all-plain path, dropout off
    batch = to_device(next(iter(val_loader)), torch.device(DEVICE))
    plain_cfg = _strong_config("")["model"]
    plain_cfg["audio_encoder"]["args"].update(gru_kernel=False,
                                              dropout=[0.0, 0.0])
    ref_model = instantiate(plain_cfg, device=DEVICE)
    ref_model.load_state_dict(sd)
    model.load_state_dict(sd)
    model.audio_encoder.dropout = (0.0, 0.0)
    gaps = _gaps(_grads(model, batch, strong_output_transform, loss_fn),
                 _grads(ref_model, batch, strong_output_transform, loss_fn))
    worst_trunk, worst_rest = _worst(gaps)
    if worst_trunk > 2e-2 or worst_rest > 1e-4:
        raise AssertionError(
            f"gradients off the plain path: trunk {worst_trunk}, rest "
            f"{worst_rest} (limits 2e-2, 1e-4): "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
    del ref_model
    model.audio_encoder.dropout = (0.2, 0.5)

    # the loss falls over 8 steps on one fixed batch
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      strong_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"loss on a fixed batch does not fall: {losses}")

    # step time on the card, TF32 off (the trainer's default), then on
    def step():
        runner.train_step(model, loss_fn, opt, batch,
                          strong_output_transform)

    step_ms = _cuda_ms(step, 5)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    step_ms_tf32 = _cuda_ms(step, 5)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report.update(
        grad_rel_rms_trunk_max=worst_trunk, grad_rel_rms_rest_max=worst_rest,
        fixed_batch_loss=losses, step_ms=step_ms,
        steps_per_s=1e3 / step_ms, clips_per_s=TRAIN_CLIPS * 1e3 / step_ms,
        step_ms_tf32=step_ms_tf32, trace=_trace(step, step_ms))
    return report


BF16_ARGS = {"dtype": "bfloat16", "gru_bwd": "bf16", "bn_pool": [64, 128],
             "pool_vjp": [256, 512]}
BF16_ROUTES = {
    "a_plain_bf16": {"dtype": "bfloat16"},
    "b_bn_pool_gru_bf16": {"dtype": "bfloat16", "gru_bwd": "bf16",
                           "bn_pool": [64, 128, 256, 512]},
    "c_pool_vjp_gru_bf16": {"dtype": "bfloat16", "gru_bwd": "bf16",
                            "pool_vjp": [64, 128, 256, 512]},
}
# Gradients of the kernel route against the plain bf16 route (pool
# kernels off, the f32 GRU loop), by relative RMS: (conv trunk, after it).
# bf16 roundings flip max-pool and ReLU routings, so a bf16 step's
# gradients move when the waveform is scaled by 1 + 1e-6: the plain route
# itself by 0.214 / 0.0085, while the kernel route lies 0.153 / 0.0056 off
# it (on an H100 80GB HBM3 at 700 W).  The kernel route is held to
# GRAD_LIMITS_BF16, and to GRAD_SELF_MULT times the plain route's own
# change in the same run; a trunk gradient halved, or one after it 2 %
# wrong, fails.
GRAD_LIMITS_BF16, GRAD_SELF_MULT = (0.3, 0.02), 2.0


def training_bf16_phase(tok) -> dict:
    import tempfile

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    report: dict = {"clips_per_batch": TRAIN_CLIPS, "clip_s": CLIP_S,
                    "audio_encoder_args": BF16_ARGS}
    with tempfile.TemporaryDirectory(prefix="ttg_train_bf16_") as tmp:
        runner = StrongRunner(device=DEVICE)
        config = runner.setup(_strong_config(tmp, **BF16_ARGS))
        exp_dir = runner.prepare_experiment()
        train_loader, val_loader = _loaders(tok, config["seed"])
        model = runner.build_model()
        if model.audio_encoder.dtype != torch.bfloat16:
            raise AssertionError("the config did not build the bf16 model")
        sd = random_state_dict(model, seed=1)
        model.load_state_dict(sd)
        loss_fn = runner.build_loss()

        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = runner.fit(model, loss_fn, train_loader, val_loader,
                            strong_output_transform, exp_dir)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _counts()
        steps = TRAIN_EPOCHS * TRAIN_STEPS
        vals = TRAIN_EPOCHS * VAL_STEPS
        want = _want(logmel=steps + vals, bn_pool_fwd=2 * steps,
                     bn_pool_bwd=2 * steps, bn_pool_stats=2 * steps,
                     dual_pool_fwd=2 * (steps + vals),
                     dual_pool_bwd=2 * steps, gru_fwd_bf16=steps,
                     gru_bwd_bf16=steps)
        if launches != want:
            raise AssertionError(f"bf16 fit: kernel launches {launches}, "
                                 f"expected {want}")
        if not all(np.isfinite(record["step_loss"] + record["val_loss"])):
            raise AssertionError(f"bf16 fit: loss not finite {record}")
        for name in ("best.pth", "last.pth", "train.log"):
            if not (exp_dir / name).is_file():
                raise AssertionError(f"bf16 fit: {name} not written")
        report.update(fit_s=fit_s, fit_launches=launches,
                      fit_step_loss=record["step_loss"],
                      fit_val_loss=record["val_loss"])

    # gradients: the kernel route against the plain bf16 route, dropout
    # off, beside the plain route's own change under a 1e-6 scaling
    batch = to_device(next(iter(val_loader)), torch.device(DEVICE))
    scaled = dict(batch, waveform=batch["waveform"] * (1 + 1e-6))
    ref_model = instantiate(_strong_config(
        "", dtype="bfloat16", gru_kernel=False,
        dropout=[0.0, 0.0])["model"], device=DEVICE)
    ref_model.load_state_dict(sd)
    model.load_state_dict(sd)
    model.audio_encoder.dropout = (0.0, 0.0)
    ref = _grads(ref_model, batch, strong_output_transform, loss_fn)
    gaps = _gaps(_grads(model, batch, strong_output_transform, loss_fn), ref)
    self_gaps = _gaps(_grads(ref_model, scaled, strong_output_transform,
                             loss_fn), ref)
    worst = _worst(gaps)
    limits = [min(lim, GRAD_SELF_MULT * own)
              for lim, own in zip(GRAD_LIMITS_BF16, _worst(self_gaps))]
    if worst[0] > limits[0] or worst[1] > limits[1]:
        raise AssertionError(
            f"bf16 gradients off the plain bf16 route: trunk {worst[0]}, "
            f"rest {worst[1]} (limits {limits}): "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
    del ref_model, ref
    model.audio_encoder.dropout = (0.2, 0.5)

    # the loss falls over 8 steps on one fixed batch
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      strong_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 loss on a fixed batch does not fall: "
                             f"{losses}")
    del model, opt

    # three routes, timed in turns a b c c b a, each profiled once
    models = {}
    for name, args in BF16_ROUTES.items():
        m = instantiate(_strong_config("", **args)["model"], device=DEVICE)
        m.load_state_dict(sd)
        models[name] = (m, Optimizer(config["optimizer"], m.parameters(),
                                     1.0))
    runs = {name: [] for name in BF16_ROUTES}
    for name in list(BF16_ROUTES) + list(reversed(BF16_ROUTES)):
        m, opt = models[name]
        runs[name].append(_cuda_ms(lambda: runner.train_step(
            m, loss_fn, opt, batch, strong_output_transform), 5))
    routes = {}
    for name, (m, opt) in models.items():
        ms = float(np.mean(runs[name]))
        routes[name] = {
            "audio_encoder_args": BF16_ROUTES[name], "step_ms": ms,
            "step_ms_runs": runs[name], "clips_per_s": TRAIN_CLIPS * 1e3 / ms,
            "trace": _trace(lambda: runner.train_step(
                m, loss_fn, opt, batch, strong_output_transform), ms)}
    report.update(
        grad_rel_rms_trunk_max=worst[0], grad_rel_rms_rest_max=worst[1],
        grad_limits=limits,
        plain_self_rel_rms_trunk_max=_worst(self_gaps)[0],
        plain_self_rel_rms_rest_max=_worst(self_gaps)[1],
        fixed_batch_loss=losses, routes=routes)
    return report


# The WSTAG config (configs/weak_phrase/cnn8rnn_w2vmean_similarity.yaml)
# at full width: 32 clips x 10 s x 32 phrases a batch, the vocabulary's
# 5221 words, a seeded pool of phrases and a random 512-d phrase embedding
WEAK_VOCAB, WEAK_PHRASES, WEAK_POOL = 5221, 32, 3000
WEAK_ROUTES = {"a_v1": None, "b_v2": "v2", "c_v3": "v3"}


def _weak_config(exp_dir: str, **audio_args) -> dict:
    """The similarity config's model, loss, optimizer, scheduler and
    trainer, the epochs cut to ``TRAIN_EPOCHS`` of ``TRAIN_STEPS``."""
    return {
        "experiment_path": exp_dir, "seed": 1,
        "model": {"type": "MultiTextBiEncoder",
                  "args": {"shared_dim": 512, "add_proj": False,
                           "pooling": "linear_softmax",
                           "text_forward_keys": ["text", "text_len"]},
                  "audio_encoder": {"type": "Cnn8Rnn", "args": {
                      "sample_rate": SR, "freeze_cnn": False,
                      "freeze_bn": False, **audio_args}},
                  "text_encoder": {"type": "EmbeddingAgg",
                                   "args": {"vocab_size": WEAK_VOCAB,
                                            "embed_dim": 512}},
                  "match_fn": {"type": "DotProduct", "args": {}}},
        "loss": {"type": "ClipBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "patience": 3}},
        "trainer": {"epochs": TRAIN_EPOCHS, "epoch_length": TRAIN_STEPS,
                    "early_stop": 10, "save_interval": 10,
                    "include_optim_in_ckpt": False, "max_grad_norm": 1.0,
                    "metric_monitor": {"mode": "min", "name": "loss"}},
    }


def _weak_loaders(tmp: str, tok, seed: int) -> tuple:
    """(train, validation) loaders of ``AudioSamplePhrasesDataset`` over
    data made in memory: captions of 2-6 phrases from a seeded pool over
    the vocabulary, a random 512-d phrase embedding written as the
    ``.pkl`` the similarity strategy reads, and 10 s noise clips (the
    dataset's ``load_audio`` returns one of 16 made once, in float16 as
    the packed HDF5 files hold)."""
    import pickle
    import zlib

    import numpy as np

    from texttoaudiogrounding_tpu_torch.data.collate import TextCollate
    from texttoaudiogrounding_tpu_torch.data.datasets import (
        AudioSamplePhrasesDataset)
    from texttoaudiogrounding_tpu_torch.data.loader import build_loader

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2, WEAK_VOCAB)]
    pool = sorted({" ".join(rng.choice(words, int(rng.integers(1, 5))))
                   for _ in range(WEAK_POOL)})
    emb_path = Path(tmp) / "phrase_embedding.pkl"
    with open(emb_path, "wb") as f:
        pickle.dump({p: rng.normal(size=512).astype(np.float32)
                     for p in pool}, f)
    noise = [rng.normal(0, 0.01, SR * CLIP_S).astype(np.float16)
             for _ in range(16)]

    class InMemory(AudioSamplePhrasesDataset):
        def load_audio(self, audio_id, file_path):
            return noise[zlib.crc32(audio_id.encode()) % len(noise)]

    def dataset(prefix: str, count: int):
        label = [{"audiocap_id": i, "audio_id": f"{prefix}{i}",
                  "tokens": "",
                  "phrases": [str(p) for p in rng.choice(
                      pool, int(rng.integers(2, 7)), replace=False)]}
                 for i in range(count)]
        index = Path(tmp) / f"{prefix}_waveform.csv"
        index.write_text("audio_id\tfile_path\n" + "".join(
            f"{it['audio_id']}\tmemory.h5\n" for it in label))
        return InMemory(str(index), label, phrase_num=WEAK_PHRASES,
                        fix_neg=False, neg_samp_stratg="similarity",
                        max_audio_length=float(CLIP_S),
                        phrase_embed=str(emb_path), sim_threshold=0.5,
                        seed=seed)

    collate = TextCollate(tok, text_key="phrases", pad_keys=["waveform"],
                          pad_buckets={"waveform": 32000}, text_bucket=4)
    train = dataset("train", TRAIN_CLIPS * TRAIN_STEPS * TRAIN_EPOCHS)
    val = dataset("val", TRAIN_CLIPS * VAL_STEPS)
    return (build_loader(train, collate, seed, batch_size=TRAIN_CLIPS,
                         shuffle=True, drop_last=True),
            build_loader(val, collate, seed, batch_size=TRAIN_CLIPS))


def training_weak_phase(tok) -> dict:
    """``WeakPhraseRunner.fit`` on the WSTAG similarity config at full
    width, once with each hoisted backward (``gru_bwd`` v2, then v3),
    the counts set to 0 before each fit; gradients of both against the
    all-plain path, the loss on one batch, checkpoints; then the three
    GRU backwards timed in turns a b c c b a and profiled once each."""
    import tempfile

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseRunner, weak_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    report: dict = {"clips_per_batch": TRAIN_CLIPS, "clip_s": CLIP_S,
                    "phrases_per_clip": WEAK_PHRASES, "fits": {}}
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    vals = TRAIN_EPOCHS * VAL_STEPS
    runner = WeakPhraseRunner(device=DEVICE)
    with tempfile.TemporaryDirectory(prefix="ttg_train_weak_") as tmp:
        for bwd in ("v2", "v3"):
            config = runner.setup(_weak_config(f"{tmp}/{bwd}", gru_bwd=bwd))
            exp_dir = runner.prepare_experiment()
            train_loader, val_loader = _weak_loaders(tmp, tok,
                                                     config["seed"])
            model = runner.build_model()
            sd = random_state_dict(model, seed=2)
            model.load_state_dict(sd)
            loss_fn = runner.build_loss()
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            record = runner.fit(model, loss_fn, train_loader, val_loader,
                                weak_output_transform, exp_dir)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = _counts()
            want = _want(gru_fwd=steps + vals, **{f"gru_bwd_{bwd}": steps})
            if launches != want:
                raise AssertionError(f"weak fit ({bwd}): kernel launches "
                                     f"{launches}, expected {want}")
            if not all(np.isfinite(record["step_loss"]
                                   + record["val_loss"])):
                raise AssertionError(f"weak fit ({bwd}): loss not finite "
                                     f"{record}")
            for name in ("best.pth", "last.pth", "train.log"):
                if not (exp_dir / name).is_file():
                    raise AssertionError(f"weak fit ({bwd}): {name} not "
                                         "written")
            ckpt = torch.load(exp_dir / "last.pth", weights_only=True)
            if not ckpt["save_trainable_only"]:
                raise AssertionError("weak fit: save_trainable_only unset")
            report["fits"][bwd] = {"fit_s": fit_s, "launches": launches,
                                   "step_loss": record["step_loss"],
                                   "val_loss": record["val_loss"]}
        batch = to_device(next(iter(val_loader)), torch.device(DEVICE))

    # gradients of both hoisted routes against the all-plain path
    plain_cfg = _weak_config("", gru_kernel=False, dropout=[0.0, 0.0])
    ref_model = instantiate(plain_cfg["model"], device=DEVICE)
    ref_model.load_state_dict(sd)
    ref = _grads(ref_model, batch, weak_output_transform, loss_fn)
    del ref_model
    worst = {}
    for bwd in ("v2", "v3"):
        m = instantiate(_weak_config("", gru_bwd=bwd,
                                     dropout=[0.0, 0.0])["model"],
                        device=DEVICE)
        m.load_state_dict(sd)
        gaps = _gaps(_grads(m, batch, weak_output_transform, loss_fn), ref)
        worst[bwd] = _worst(gaps)
        if worst[bwd][0] > 2e-2 or worst[bwd][1] > 1e-4:
            raise AssertionError(
                f"weak gradients ({bwd}) off the plain path: trunk "
                f"{worst[bwd][0]}, rest {worst[bwd][1]} (limits 2e-2, "
                f"1e-4): {sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
        del m
    del ref

    # the loss falls over 8 steps on one fixed batch
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      weak_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"weak loss on a fixed batch does not fall: "
                             f"{losses}")
    del model, opt

    # the three GRU backwards, timed in turns a b c c b a
    models = {}
    for name, bwd in WEAK_ROUTES.items():
        m = instantiate(_weak_config("", gru_bwd=bwd)["model"], device=DEVICE)
        m.load_state_dict(sd)
        models[name] = (m, Optimizer(config["optimizer"], m.parameters(),
                                     1.0))
    runs = {name: [] for name in WEAK_ROUTES}
    for name in list(WEAK_ROUTES) + list(reversed(WEAK_ROUTES)):
        m, opt = models[name]
        runs[name].append(_cuda_ms(lambda: runner.train_step(
            m, loss_fn, opt, batch, weak_output_transform), 5))
    routes = {}
    for name, (m, opt) in models.items():
        ms = float(np.mean(runs[name]))
        routes[name] = {
            "gru_bwd": WEAK_ROUTES[name], "step_ms": ms,
            "step_ms_runs": runs[name], "clips_per_s": TRAIN_CLIPS * 1e3 / ms,
            "trace": _trace(lambda: runner.train_step(
                m, loss_fn, opt, batch, weak_output_transform), ms)}
    report.update(
        grad_rel_rms_max={k: {"trunk": v[0], "rest": v[1]}
                          for k, v in worst.items()},
        fixed_batch_loss=losses, routes=routes)
    return report


@functools.lru_cache(maxsize=None)
def _port_kernel_pattern():
    """A pattern for the port's kernels in a profiled kernel name: each
    ``__global__`` function of ``csrc/``, as a whole identifier of the
    demangled name."""
    import re

    from texttoaudiogrounding_tpu_torch.ops.kernels import _build
    names = set()
    for f in _build.CSRC.glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", f.read_text()))
    return re.compile(r"(?:^|[\s:])(?:" + "|".join(sorted(names)) + r")[<(]")


_CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def _trace(fn, request_ms: float, by_launch: bool = False) -> dict:
    """Device time by kernel name over one profiled call of ``fn``, and the
    device's idle share of the untraced time ``request_ms`` (kernels run
    on one stream, so their times add up).  ``gru_ms`` sums the port's
    GRU kernels, ``conv_ms`` the device time under PyTorch's convolution
    operators, forward and backward (the plain path's convolutions),
    ``pool_ms`` the pool kernels; with ``by_launch`` also each launch's
    device ms in launch order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    # a by-launch trace of a call that launches kernels is taken again
    # when the profiler recorded none of them (only a memset, once), which
    # happened once in dozens of profiles on an H100
    for attempt in range(1, 4 if by_launch else 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the first kernel launched under the profiler can go
            # unrecorded on the card's machine: a marker kernel takes
            # that place, and is left out by its name if it was recorded
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        launched = sorted((e for e in events
                           if "spin_kernel" not in e.name),
                          key=lambda e: e.time_range.start)
        if any(not e.name.startswith(("Memset", "Memcpy"))
               for e in launched):
            break
    kernels = {}
    for e in launched:
        ms, count = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    conv_ms = 0.0
    for evt in prof.key_averages():
        if evt.key in _CONV_OPS:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = evt.cuda_time_total
            conv_ms += total / 1e3
    busy = sum(ms for ms, _ in kernels.values())
    port = sum(ms for k, (ms, _) in kernels.items() 
               if _port_kernel_pattern().search(k))
    gru_ms = sum(ms for k, (ms, _) in kernels.items() if "gru_" in k)
    pool_ms = sum(ms for k, (ms, _) in kernels.items()
                  if "dual_pool_" in k or "bn_pool_" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    order = {}
    if by_launch:
        order["by_launch"] = [{"kernel": e.name[:60],
                               "ms": e.time_range.elapsed_us() / 1e3}
                              for e in launched]
    return {**order, "attempts": attempt,
            "marker_recorded": len(events) - len(launched),
            "request_ms": request_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / request_ms,
            "port_kernels_ms": port, "gru_ms": gru_ms, "pool_ms": pool_ms,
            "conv_ms": conv_ms,
            "launches": sum(c for _, c in kernels.values()),
            "top": [{"kernel": k[:90], "ms": ms, "count": c}
                    for k, (ms, c) in top]}


def _ptxas(source: str) -> list:
    """Registers, static shared memory, stack and spills of each kernel of
    ``csrc/<source>.cu`` from its ``nvcc -Xptxas=-v`` build log, with the
    GEMM's dynamic shared memory (``igemm_smem``: 4 ring stages of
    (128 + BN) rows x 64 bytes, and 1024 bytes to align them) and the
    cluster GRU kernels' (``gru.cluster_plan``, ``forward_plan`` and
    ``walk_plan`` at the main path's shape)."""
    import re
    import shutil

    from texttoaudiogrounding_tpu_torch.ops.kernels import _build
    log = _build._lib_path(_build.CSRC / f"{source}.cu").with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    names = [k["function"] for k in out]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    for k, name in zip(out, names):
        k["function"] = name
        bn = re.search(r"igemm_kernel<[^,]+, (\d+), (\d+)(, true)?", name)
        if bn and bn.group(3):
            # the slab form: 3 (BN = 256) or 4 stages of a 256-row slab
            # and three B slices
            n = int(bn.group(1))
            k["dynamic_smem"] = ((3 if n == 256 else 4)
                                 * (256 + 3 * n) * 64 + 1024)
        elif bn:
            k["dynamic_smem"] = 4 * (128 + int(bn.group(1))) * 64 + 1024
        if "logmel_v4_v2_kernel" in name:
            # the ring (4 x (128 + 256) rows of 64 bytes), pw (128 bins x
            # 136 frames), band and 1024 weights, 10 barriers, the align
            k["dynamic_smem"] = (4 * 384 * 64 + 128 * 136 * 4 + 64 * 3 * 4
                                 + 1024 * 4 + 10 * 8 + 1024)
        if "wino_fold_kernel<" in name:
            # the ring (7 x (128 + 64) rows of 64 bytes), the four y and
            # the scales
            k["dynamic_smem"] = (7 * 192 * 64 + 4 * 32 * 256 * 4
                                 + 16 * 192 * 4 + 1024)
        plans = {"gru_bwd_cluster<": "cluster_plan",
                 "gru_fwd_cluster<": "forward_plan",
                 "gru_walk_cluster<": "walk_plan"}
        plan = next((v for key, v in plans.items() if key in name), None)
        if plan:
            from texttoaudiogrounding_tpu_torch.ops.kernels import gru
            k["dynamic_smem"] = getattr(gru, plan)(KERNEL_CLIPS,
                                                   GRU_H)["smem"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for a JSON report and the build logs")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "texttoaudiogrounding_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: texttoaudiogrounding_tpu_torch is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # the plain versions run in full f32 on the card: cuDNN would run f32
    # convolutions (and matmul might run) in TF32 otherwise
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
    from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
    from texttoaudiogrounding_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build_s = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": [s.name for s in _build.sources()],
                      "card": smi}), flush=True)
    ptxas = {src: _ptxas(src) for src in ("conv_block_v2", "conv_block1_v2",
                                          "logmel_v2", "gru_fwd_sm90",
                                          "gru_bwd_sm90", "gru_walk_sm90",
                                          "bn_pool_v2", "conv_block_wino_v2",
                                          "conv_block_tri_v2",
                                          "conv_block_mel3_v2",
                                          "pair_conv_pool_v2",
                                          "block1_small_v2", "logmel_v3_v2",
                                          "logmel_v4_v2")}
    print(json.dumps({"phase": "ptxas", "kernels": ptxas}), flush=True)
    report = {"card": smi, "build_s": build_s, "ptxas": ptxas}
    rng = np.random.default_rng(0)
    kernels = (kernel_phase(KERNEL_CLIPS, rng)
               + gru_kernel_phase(KERNEL_CLIPS, rng)
               + pool_kernel_phase(KERNEL_CLIPS))
    print(json.dumps({"phase": "kernels", "card": smi, "kernels": [
        {k: row[k] for k in ("name", "max_abs_err", "rel_rms_err",
                             "tolerance", "kernel_ms", "plain_ms")}
        for row in kernels]}), flush=True)

    vocab = Vocabulary()
    for word in ["<pad>", "<unk>"] + [f"w{i}" for i in range(2, 5000)]:
        vocab.add_word(word)
    tok = DictTokenizer(vocab)
    serving, handoff = serving_phase(rng, tok)
    report["serving"] = serving
    print(json.dumps({"phase": "serving", "card": smi,
                      "clips_per_s": serving["clips_per_s"],
                      "largest": serving["largest"],
                      "requests": serving["requests"],
                      "paths": {k: {"clips_per_s": v["clips_per_s"],
                                    "launches": v["trace"]["launches"],
                                    "device_idle_share":
                                        v["trace"]["device_idle_share"]}
                                for k, v in serving["paths"].items()}}),
          flush=True)
    designs, design_launches, v1_route = designs_phase(*handoff)
    del handoff
    report["v1_route"] = v1_route
    print(json.dumps({"phase": "v1_route", "card": smi, "rows": v1_route}),
          flush=True)
    kernels += designs
    print(json.dumps({"phase": "designs", "card": smi, "kernels": [
        {k: v for k, v in row.items() if k not in (
            "route", "source", "replaces", "tolerance", "library")
            and not k.endswith("trace")}
        for row in designs]}), flush=True)
    train = training_phase(tok)
    report["train"] = train
    print(json.dumps({"phase": "train", "card": smi, **{
        k: train[k] for k in ("steps_per_s", "clips_per_s", "step_ms",
                              "step_ms_tf32", "tf32", "fit_launches",
                              "fixed_batch_loss", "grad_rel_rms_trunk_max",
                              "grad_rel_rms_rest_max")},
        "gru_ms": train["trace"]["gru_ms"],
        "conv_ms": train["trace"]["conv_ms"],
        "device_idle_share": train["trace"]["device_idle_share"]}),
        flush=True)

    train16 = training_bf16_phase(tok)
    report["train_bf16"] = train16
    print(json.dumps({"phase": "train_bf16", "card": smi, **{
        k: train16[k] for k in ("fit_launches", "fixed_batch_loss",
                                "grad_rel_rms_trunk_max",
                                "grad_rel_rms_rest_max", "grad_limits",
                                "plain_self_rel_rms_trunk_max",
                                "plain_self_rel_rms_rest_max")},
        "routes": {k: {"step_ms": v["step_ms"],
                       "step_ms_runs": v["step_ms_runs"],
                       "clips_per_s": v["clips_per_s"],
                       **{m: v["trace"][m] for m in (
                           "device_idle_share", "launches", "pool_ms",
                           "gru_ms", "conv_ms")}}
                   for k, v in train16["routes"].items()}}), flush=True)

    weak = training_weak_phase(tok)
    report["train_weak"] = weak
    print(json.dumps({"phase": "train_weak", "card": smi, **{
        k: weak[k] for k in ("grad_rel_rms_max", "fixed_batch_loss")},
        "fits": {k: {"fit_s": v["fit_s"], "launches": v["launches"]}
                 for k, v in weak["fits"].items()},
        "routes": {k: {"step_ms": v["step_ms"],
                       "step_ms_runs": v["step_ms_runs"],
                       "clips_per_s": v["clips_per_s"],
                       **{m: v["trace"][m] for m in (
                           "device_idle_share", "launches", "gru_ms",
                           "conv_ms")}}
                   for k, v in weak["routes"].items()}}), flush=True)

    # launches on each path, counted from zero just before it
    by_path = {"serving": {**serving["launches"], "gru_fwd_bf16":
                           serving["gru_fwd_bf16_launches"]},
               "serving_block1_int8": serving["block1_int8_launches"],
               "serving_block1_single": serving["block1_single_launches"],
               "designs": design_launches,
               "train": train["fit_launches"],
               "train_bf16": train16["fit_launches"],
               **{f"train_weak_{k}": v["launches"]
                  for k, v in weak["fits"].items()}}
    for row in kernels:
        counter = row.get("counter", row["name"])
        row["launches_by_path"] = {p: c.get(counter, 0)
                                   for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on any path")
    report["kernels"] = kernels
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
        for log in _build.build_dir().glob("*.log"):
            (out / log.name).write_text(log.read_text())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
