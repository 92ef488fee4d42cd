#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card (an H100).

    python3 chip_smoke.py [--out DIR] [--trace]

Phases, each printing one line:

1. build: compile every kernel of ``texttoaudiogrounding_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and print the card's name and
   power limit as ``nvidia-smi`` reports them;
2. kernels: run each of the four kernels at the flagship's shapes of the
   largest request (32 clips of 10 s at 32 kHz, one batch bucket) against
   its plain PyTorch version on the same inputs on the card, with the
   stated tolerance, and time both with CUDA events;
3. serving: ``GroundingPredictor`` over the flagship ``BiEncoder`` at full
   width (Cnn8Rnn 64/128/256/512, BiGRU 2x256, vocabulary 5000, embedding
   512, shared 512) with random weights from a numpy seed answers requests
   of several batch sizes and lengths, the largest 32 clips x 10 s; every
   kernel's launch count must rise as each sub-batch's forward requires,
   ``frame_sim`` must be finite in (0, 1] with the reference length
   arithmetic, and within 0.05 of the port's plain f32 path on the card;
   the audio embedding of every sub-batch, taken from the very forward
   that served the request, must lie within 5 % relative RMS of the plain
   f32 path on the same padded input.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Without a CUDA device, or without the package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
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
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        conv_block, conv_block1_pair, conv_block_pair, logmel)

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

    # ---- log-mel
    wave = tensor(rng.normal(0, 0.1, (clips, n)))
    got = logmel.fused_log_mel_spectrogram(wave, cfg)
    ref = logmel.log_mel_plain(wave, cfg)
    ops = {"bf16": 2.0 * clips * t1 * 1024 * 1024,
           "f32": 2.0 * clips * t1 * 512 * 64 + 3.0 * clips * t1 * 512}
    rows.append(dict(
        name="logmel", source="texttoaudiogrounding_tpu_torch/csrc/logmel.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/logmel.py:438",
        got=got, ref=ref, tol=("max_abs_db", 2e-3),
        kernel=lambda: logmel.fused_log_mel_spectrogram(wave, cfg),
        plain=lambda: logmel.log_mel_plain(wave, cfg),
        bound=_bound(wave.numel() * 4 + got.numel() * 4, ops)))

    # ---- block 1: [B, 1001, 64] -> [B, 500, 32, 64], int8 conv1
    x1 = tensor(rng.normal(0, 1, (clips, t1, 64)), torch.bfloat16)
    w = weights(1, 64)
    got = conv_block1_pair.fused_block1_pair(x1, *w, quantize="conv1")
    ref = conv_block1_pair.block1_plain(x1, *w, quantize="conv1")
    ops = {"int8": 2.0 * clips * t1 * 64 * 9 * 64,
           "bf16": 2.0 * clips * (t1 // 2 * 2) * 64 * 576 * 64}
    rows.append(dict(
        name="conv_block1_pair",
        source="texttoaudiogrounding_tpu_torch/csrc/conv_block1_pair.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/conv_block1_pair.py:346",
        got=got, ref=ref, tol=("rel_rms", 1e-2),
        kernel=lambda w=w: conv_block1_pair.fused_block1_pair(x1, *w),
        plain=lambda w=w: conv_block1_pair.block1_plain(x1, *w),
        bf16=lambda w=w: (
            conv_block1_pair.fused_block1_pair(x1, *w, quantize=False),
            conv_block1_pair.block1_plain(x1, *w, quantize=False)),
        bound=_bound(x1.numel() * 2 + got.numel() * 2 + _wbytes(w), ops)))

    # ---- block 2: [B, 500, 32, 64] -> [B, 250, 16, 128], int8
    t2 = t1 // 2
    x2 = tensor(np.abs(rng.normal(0, 1, (clips, t2, 32, 64))), torch.bfloat16)
    w = weights(64, 128)
    tc2 = conv_block_pair.pick_tc_pair(t2, 16, 128, True)
    got = conv_block_pair.fused_block2_pair(x2, *w, quantize=True)
    ref = conv_block_pair.block2_plain(x2, *w, quantize=True, tc=tc2)
    pos = clips * t2 * 32
    ops = {"int8": 2.0 * pos * 576 * 128 + 2.0 * pos * 1152 * 128}
    rows.append(dict(
        name="conv_block_pair",
        source="texttoaudiogrounding_tpu_torch/csrc/conv_block_pair.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/conv_block_pair.py:211",
        got=got, ref=ref, tol=("rel_rms", 1e-2),
        kernel=lambda w=w: conv_block_pair.fused_block2_pair(
            x2, *w, quantize=True),
        plain=lambda w=w: conv_block_pair.block2_plain(
            x2, *w, quantize=True, tc=tc2),
        bf16=lambda w=w: (
            conv_block_pair.fused_block2_pair(x2, *w, quantize=False),
            conv_block_pair.block2_plain(
                x2, *w, quantize=False,
                tc=conv_block_pair.pick_tc_pair(t2, 16, 128, False))),
        bound=_bound(x2.numel() * 2 + got.numel() * 2 + _wbytes(w), ops)))

    # ---- blocks 3 and 4: one kernel, two launches per forward
    t3 = t2 // 2
    parts, bf16_34 = [], []
    for m, cin, cout in ((16, 128, 256), (8, 256, 512)):
        x = tensor(np.abs(rng.normal(0, 1, (clips, t3, m, cin))),
                   torch.bfloat16)
        w = weights(cin, cout)
        tc = conv_block.pick_tc(t3, m, cin, cout, 1, 2, True)
        g = conv_block.fused_double_conv_pool(x, *w, (1, 2), quantize=True)
        r = conv_block.double_conv_plain(x, *w, (1, 2), quantize=True, tc=tc)
        pos = clips * t3 * m
        ops = {"int8": 2.0 * pos * 9 * cin * cout
               + 2.0 * pos * 9 * cout * cout}
        tc16 = conv_block.pick_tc(t3, m, cin, cout, 1, 2, False)
        bf16_34.append((
            conv_block.fused_double_conv_pool(x, *w, (1, 2)).reshape(-1),
            conv_block.double_conv_plain(x, *w, (1, 2), quantize=False,
                                         tc=tc16).reshape(-1)))
        parts.append((x, w, tc, g, r,
                       _bound(x.numel() * 2 + g.numel() * 2 + _wbytes(w),
                              ops)))
    rows.append(dict(
        name="conv_block",
        source="texttoaudiogrounding_tpu_torch/csrc/conv_block.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/conv_block.py:370",
        got=torch.cat([p[3].reshape(-1) for p in parts]),
        ref=torch.cat([p[4].reshape(-1) for p in parts]),
        tol=("rel_rms", 1e-2),
        kernel=lambda: [conv_block.fused_double_conv_pool(
            p[0], *p[1], (1, 2), quantize=True) for p in parts],
        plain=lambda: [conv_block.double_conv_plain(
            p[0], *p[1], (1, 2), quantize=True, tc=p[2]) for p in parts],
        bf16=lambda: (torch.cat([b[0] for b in bf16_34]),
                      torch.cat([b[1] for b in bf16_34])),
        bound=(sum(p[5][0] for p in parts), parts[1][5][1])))

    out = []
    for row in rows:
        max_abs, rel = _err(row["got"], row["ref"])
        kind, tol = row["tol"]
        ok = (max_abs if kind == "max_abs_db" else rel) <= tol
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
        kernel_ms = _cuda_ms(row["kernel"], 10)
        plain_ms = _cuda_ms(row["plain"], 3)
        out.append({
            "name": row["name"], "route": "cuda", "source": row["source"],
            "replaces": row["replaces"], "max_abs_err": max_abs,
            "rel_rms_err": rel, "tolerance": f"{kind} <= {tol}",
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": None, "clips": clips,
            "bf16_mode_rel_rms_err": bf16_rel})
    return out


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


def serving_phase(rng, trace: bool = False) -> dict:
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import (
        GroundingPredictor, flagship_model, random_state_dict)
    from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
    from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        conv_block, conv_block1_pair, conv_block_pair, logmel)

    counters = {"logmel": logmel, "conv_block1_pair": conv_block1_pair,
                "conv_block_pair": conv_block_pair, "conv_block": conv_block}
    per_forward = {"logmel": 1, "conv_block1_pair": 1, "conv_block_pair": 1,
                   "conv_block": 2}

    vocab = Vocabulary()
    for word in ["<pad>", "<unk>"] + [f"w{i}" for i in range(2, 5000)]:
        vocab.add_word(word)
    tok = DictTokenizer(vocab)
    model = flagship_model(serving=True, device=DEVICE)
    sd = random_state_dict(model, seed=0)
    model.load_state_dict(sd)
    plain = flagship_model(serving=False, device=DEVICE)
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
    for mod in counters.values():
        mod.launches = 0
    totals = dict.fromkeys(counters, 0)   # launches by predict() alone
    results = []
    for label, lens in requests:
        b = len(lens)
        width = max(lens)
        audio = np.zeros((b, width), np.float32)
        for i, ln in enumerate(lens):
            audio[i, :ln] = rng.normal(0, 0.1, ln)
        text = [" ".join(f"w{int(v)}" for v in rng.integers(2, 5000, 3))
                for _ in range(b)]
        before = {k: m.launches for k, m in counters.items()}
        served.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, lengths = pred.predict(audio, lens, text, return_length=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        subs = len(pred._chunk_plan(b))
        for k, m in counters.items():
            grew = m.launches - before[k]
            if grew != subs * per_forward[k]:
                raise AssertionError(f"{label}: {k} launched {grew} times, "
                                     f"expected {subs * per_forward[k]}")
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
        results.append({"request": label, "clips": b, "sub_batches": subs,
                        "seconds": seconds, "max_abs_vs_plain_f32": delta,
                        "embedding_rel_rms_vs_plain_f32": emb_rel,
                        "frame_sim_mean": float(probs[valid].mean())})

    hook.remove()
    served.clear()

    # steady-state throughput of the largest request
    label, lens = requests[-1]
    audio = (rng.normal(0, 0.1, (len(lens), n))).astype(np.float32)
    text = ["w2 w3 w4"] * len(lens)
    pred.predict(audio, lens, text)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict(audio, lens, text)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    secs = float(np.median(times))
    out = {"requests": results, "launches": totals,
           "clips_per_s": len(lens) / secs, "request_s": secs,
           "request_s_all": times, "largest": label}
    if trace:
        out["trace"] = _trace(lambda: pred.predict(audio, lens, text),
                              secs * 1e3)
    return out


_PORT_KERNELS = ("logmel_kernel", "conv3x3_gemm", "gather_kernel",
                 "conv1_kernel", "clip_scale_kernel")


def _trace(fn, request_ms: float) -> dict:
    """Device time by kernel name over one profiled request, and the
    device's idle share of the untraced request time ``request_ms``
    (kernels run on one stream, so their times add up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (kernels.get(evt.key, (0.0, 0))[0] + us / 1e3,
                            evt.count)
    busy = sum(ms for ms, _ in kernels.values())
    port = sum(ms for k, (ms, _) in kernels.items()
               if any(p in k for p in _PORT_KERNELS))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"request_ms": request_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / request_ms,
            "port_kernels_ms": port,
            "launches": sum(c for _, c in kernels.values()),
            "top": [{"kernel": k[:90], "ms": ms, "count": c}
                    for k, (ms, c) in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for a JSON report and the build logs")
    ap.add_argument("--trace", action="store_true",
                    help="profile one largest request (device time by "
                         "kernel, idle share) into the report")
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

    from texttoaudiogrounding_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build_s = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": [s.name for s in _build.sources()],
                      "card": smi}), flush=True)
    report = {"card": smi, "build_s": build_s}
    rng = np.random.default_rng(0)
    kernels = kernel_phase(KERNEL_CLIPS, rng)
    print(json.dumps({"phase": "kernels", "card": smi, "kernels": [
        {k: row[k] for k in ("name", "max_abs_err", "rel_rms_err",
                             "tolerance", "kernel_ms", "plain_ms")}
        for row in kernels]}), flush=True)
    serving = serving_phase(rng, args.trace)
    report["serving"] = serving
    print(json.dumps({"phase": "serving", "card": smi,
                      "clips_per_s": serving["clips_per_s"],
                      "largest": serving["largest"],
                      "requests": serving["requests"]}), flush=True)
    if "trace" in serving:
        print(json.dumps({"phase": "trace", **serving["trace"]}), flush=True)
    for row in kernels:
        row["launches"] = serving["launches"][row["name"]]
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
