"""Ranks of ``torch.distributed`` (gloo, on the CPU) for the port's
multi-rank tests.

    python -m tests.torch_ranks OUT_DIR

reads ``OUT_DIR/jobs.json`` (``[{"name", "fn", "world", "args"}, ...]``)
and runs each job as one world of ranks: this process imports torch and
the port once, then forks every job's ranks together, each of which joins
its world's gloo group on a free local port, runs ``JOBS[fn](args)`` and
saves its result to ``OUT_DIR/<name>.<rank>.pt`` (a failure's traceback
to ``.err``).  A world that outlives its job's ``timeout`` (default 90 s)
is killed (a rank that dies leaves the others waiting in a collective).
:func:`start` and :func:`results` drive it from a test; the job functions
also run in the test's own process on one rank (no group) for the
references.  Nothing here imports JAX or the JAX package: each rank
reports the JAX modules it holds (``jax_modules``).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 100
EMBED = 64
SAMPLES = 6400                     # 0.2 s at 32 kHz
RULES = [{"match": ["fc1", "kernel"], "spec": [None, "model"]},
         {"match": ["text_encoder", "embed", "embedding"],
          "spec": ["model", None]}]


# ------------------------------------------------------------------ launch
def start(out_dir: Path, jobs: list) -> subprocess.Popen:
    """Start the ranks of ``jobs`` in the background."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "jobs.json").write_text(json.dumps(jobs))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    return subprocess.Popen(
        [sys.executable, "-m", "tests.torch_ranks", str(out_dir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def results(proc: subprocess.Popen, out_dir: Path, name: str,
            world: int, timeout: float = 600) -> list:
    """Every rank's result of job ``name`` (waits for the launcher)."""
    if not hasattr(proc, "launcher_output"):
        out, _ = proc.communicate(timeout=timeout)
        proc.launcher_output = out.decode(errors="replace")
    out_dir = Path(out_dir)
    errors = [p.read_text() for p in sorted(out_dir.glob(f"{name}.*.err"))]
    if errors:
        raise AssertionError(f"job {name} failed:\n" + "\n".join(errors))
    missing = [r for r in range(world)
               if not (out_dir / f"{name}.{r}.pt").exists()]
    if missing:
        raise AssertionError(
            f"job {name}: no result from ranks {missing}\n"
            + getattr(proc, "launcher_output", ""))
    return [torch.load(out_dir / f"{name}.{r}.pt", weights_only=False)
            for r in range(world)]


@contextlib.contextmanager
def sharing_the_cpu(threads: int = 2):
    """The test process's torch on ``threads`` threads while ranks run
    beside it (more threads than cores make OpenMP's waits spin)."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(job: dict, rank: int, port: int, out_dir: Path) -> None:
    code = 0
    try:
        # the thread count of the test process's references
        # (sharing_the_cpu): torch's CPU kernels take other orders of
        # summation on one thread than on several, which moves the narrow
        # model's first-step trunk gradients by up to 1e-3 relative
        torch.set_num_threads(job.get("threads", 2))
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=job["world"])
        result = JOBS[job["fn"]](**job.get("args", {}))
        result["jax_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "texttoaudiogrounding_tpu"))
        torch.save(result, out_dir / f"{job['name']}.{rank}.pt")
        torch.distributed.destroy_process_group()
    except BaseException:                   # noqa: BLE001 - reported
        (out_dir / f"{job['name']}.{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        code = 1
    os._exit(code)


def main(out_dir: str) -> None:
    """Fork every job's ranks at once (each world on its own port), then
    wait for them, killing a world that outlives its time limit."""
    # the ranks fork from here with the port imported and its operators
    # warmed up once, on one thread (no thread pool exists to fork)
    t0 = time.time()
    torch.set_num_threads(1)
    steps(None, n_steps=1)
    out_dir = Path(out_dir)
    log = [f"warm: {time.time() - t0:.1f} s"]
    worlds = {}
    for job in json.loads((out_dir / "jobs.json").read_text()):
        port = _free_port()
        pids = set()
        for rank in range(job["world"]):
            pid = os.fork()
            if pid == 0:
                _rank(job, rank, port, out_dir)
            pids.add(pid)
        worlds[job["name"]] = (job, pids, time.time())
    while any(pids for _, pids, _ in worlds.values()):
        for name, (job, pids, t0) in worlds.items():
            for pid in list(pids):
                done, status = os.waitpid(pid, os.WNOHANG)
                if done:
                    pids.discard(pid)
                    if not pids:
                        log.append(f"{name}: {time.time() - t0:.1f} s")
            if pids and time.time() > t0 + job.get("timeout", 90):
                for pid in pids:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                (out_dir / f"{name}.timeout.err").write_text(
                    f"{len(pids)} of {job['world']} ranks killed after "
                    f"{time.time() - t0:.0f} s")
                pids.clear()
        time.sleep(0.02)
    (out_dir / "launcher.log").write_text("\n".join(log) + "\n")


# --------------------------------------------------------------- the jobs
def _mesh(shape: dict | None):
    from texttoaudiogrounding_tpu_torch.parallel.mesh import (
        mesh_from_config,
    )
    return mesh_from_config(None if shape is None else {"mesh": shape})


def batches(steps: int, b: int = 4, phrases: int = 0, seed: int = 1) -> list:
    """Numpy batches of ``b`` clips of 0.2 s: strong (``label [B, T]``) or,
    with ``phrases``, WSTAG (``text [B, N, 4]``, ``label [B, N]``)."""
    rng = np.random.default_rng(seed)
    frames = (SAMPLES // 320 + 1) // 4
    out = []
    for _ in range(steps):
        batch = {"waveform": (rng.normal(size=(b, SAMPLES)) * 0.1).astype(
                     np.float32),
                 "waveform_len": np.array([SAMPLES, SAMPLES - 1100]
                                          * (b // 2), np.int64)}
        if phrases:
            batch["text"] = rng.integers(1, VOCAB, (b, phrases, 4))
            batch["text_len"] = rng.integers(1, 5, (b, phrases))
            batch["label"] = (rng.random((b, phrases)) > 0.5).astype(
                np.float32)
        else:
            batch["text"] = rng.integers(1, VOCAB, (b, 4))
            batch["text_len"] = rng.integers(1, 5, (b,))
            batch["label"] = (rng.random((b, frames)) > 0.6).astype(
                np.float32)
        out.append(batch)
    return out


def model(weak: bool = False, dropout=(0.2, 0.5), seed: int = 0):
    """The narrow ``BiEncoder`` (or ``MultiTextBiEncoder``) with weights
    made from ``seed``."""
    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.models import (
        BiEncoder,
        Cnn8Rnn,
        DotProduct,
        EmbeddingAgg,
        MultiTextBiEncoder,
    )
    cls = MultiTextBiEncoder if weak else BiEncoder
    m = cls(Cnn8Rnn(dropout=dropout), EmbeddingAgg(VOCAB, EMBED),
            DotProduct(), shared_dim=EMBED, add_proj=True, device="cpu")
    m.load_state_dict(random_state_dict(m, seed))
    return m


def steps(mesh_shape: dict | None = None, weak: bool = False,
          n_steps: int = 4, dropout=(0.2, 0.5), rules=None,
          max_grad_norm=None, f64_stats: bool = False) -> dict:
    """``n_steps`` train steps of the runner's step on :func:`batches`
    under ``mesh_shape`` (None: one rank, no group): the losses, the first
    step's gradients (full shapes, before clipping) and the BatchNorms'
    running statistics after.  ``f64_stats`` sums the BatchNorms'
    statistics in float64 (``layers.STATS_DTYPE``), so that N ranks and one
    differ by no rounding of those sums."""
    from texttoaudiogrounding_tpu_torch.models import layers

    before = layers.STATS_DTYPE
    layers.STATS_DTYPE = torch.float64 if f64_stats else torch.float32
    try:
        return _steps(mesh_shape, weak, n_steps, dropout, rules,
                      max_grad_norm)
    finally:
        layers.STATS_DTYPE = before


def _steps(mesh_shape, weak, n_steps, dropout, rules,
           max_grad_norm) -> dict:
    from texttoaudiogrounding_tpu_torch.losses import ClipBceLoss, FrameBceLoss
    from texttoaudiogrounding_tpu_torch.parallel import tensor_parallel
    from texttoaudiogrounding_tpu_torch.parallel.mesh import device_feed
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner,
        strong_output_transform,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        weak_output_transform,
    )

    torch.manual_seed(1)
    mesh = _mesh(mesh_shape)
    m = model(weak, dropout)
    shards = tensor_parallel.shard_model(m, mesh, rules)
    names = [n for n, _ in m.named_parameters()]
    first: dict = {}

    first_stats: dict = {}

    class Runner(StrongRunner):
        def post_grad_hook(self, loss, grads):
            if not first:
                for name, p in zip(names, m.parameters()):
                    g = p.grad.detach()
                    first[name] = (shards[name].gather(g) if name in shards
                                   else g).clone()
                first_stats.update({n: b.clone() for n, b in
                                    m.named_buffers() if "running" in n})

    runner = Runner(device="cpu")
    runner.mesh = mesh
    opt = Optimizer({"type": "Adam", "args": {"lr": 1e-3}}, m.parameters(),
                    max_grad_norm, {m.get_parameter(n): s
                                    for n, s in shards.items()})
    loss_fn = ClipBceLoss() if weak else FrameBceLoss()
    transform = weak_output_transform if weak else strong_output_transform
    losses = []
    for batch, _, _ in device_feed(batches(n_steps, phrases=3 if weak
                                           else 0), mesh, "cpu"):
        losses.append(float(runner.train_step(m, loss_fn, opt, batch,
                                              transform)))
    return {"losses": losses, "grads": first, "first_stats": first_stats,
            "stats": {n: b.clone() for n, b in m.named_buffers()
                      if "running" in n},
            "local_shapes": {n: tuple(p.shape)
                             for n, p in m.named_parameters()},
            "moment_shapes": {n: tuple(opt.inner.state[p]["exp_avg"].shape)
                              for n, p in m.named_parameters()
                              if p in opt.inner.state}}


def bn_pool(mesh_shape: dict | None = None) -> dict:
    """Row 12's plain path (``bn_relu_dual_pool``) on a rank's rows of a
    seeded ``[4, 6, 8, 128]`` batch: out, dx, dγ, dβ (summed over the
    ranks) and the statistics."""
    from texttoaudiogrounding_tpu_torch.ops.kernels.bn_pool import (
        bn_relu_dual_pool,
    )
    from texttoaudiogrounding_tpu_torch.parallel.kernel_shard import (
        data_parallel,
    )

    mesh = _mesh(mesh_shape)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 6, 8, 128)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(4, 3, 4, 128)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, 128).astype(np.float32))
    beta = torch.from_numpy(rng.normal(size=128).astype(np.float32) * 0.1)
    axis = mesh.axis("data")
    n, i = (1, 0) if axis is None else (axis.size, axis.index)
    rows = slice(i * 4 // n, (i + 1) * 4 // n)
    x = x[rows].clone().requires_grad_()
    gamma.requires_grad_()
    beta.requires_grad_()
    with data_parallel(mesh):
        out, mean, var = bn_relu_dual_pool(x, gamma, beta, (2, 2))
    out.backward(g[rows])
    dg, db = gamma.grad.clone(), beta.grad.clone()
    if axis is not None:
        torch.distributed.all_reduce(dg, group=axis.group)
        torch.distributed.all_reduce(db, group=axis.group)
    return {"rows": (rows.start, rows.stop), "out": out.detach(),
            "dx": x.grad, "dgamma": dg, "dbeta": db, "mean": mean,
            "var": var}


def clip(mesh_shape: dict | None = None) -> dict:
    """``clip_by_global_norm_`` on seeded gradients of the narrow model
    sharded by :data:`RULES`: the norm and the clipped gradients (full
    shapes)."""
    from texttoaudiogrounding_tpu_torch.parallel import tensor_parallel
    from texttoaudiogrounding_tpu_torch.training.optim import (
        clip_by_global_norm_,
    )

    mesh = _mesh(mesh_shape)
    m = model()
    rng = np.random.default_rng(7)
    full = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
            for n, p in m.named_parameters()}
    shards = tensor_parallel.shard_model(m, mesh, RULES)
    params, cut = [], []
    for n, p in m.named_parameters():
        p.grad = shards[n].take(full[n]) if n in shards else full[n].clone()
        params.append(p)
        cut.append(shards.get(n))
    norm = clip_by_global_norm_(params, 1.0, cut)
    return {"norm": float(norm), "sharded": sorted(shards),
            "grads": {n: (shards[n].gather(p.grad) if n in shards
                          else p.grad) for n, p in m.named_parameters()}}


def runs(calls: list) -> dict:
    """The strong runner's ``train`` / ``evaluate`` calls in turn, each by
    a new runner: a train call gives its experiment directory, mesh and
    the local shapes of the parameters and Adam's first moments; an
    evaluate call its results."""
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner,
    )

    out = []
    for call in calls:
        runner = StrongRunner(device="cpu")
        if call["kind"] == "evaluate":
            out.append({"results": runner.evaluate(call["exp"],
                                                   call["eval_config"])})
            continue
        exp = runner.train(call["config"], call.get("overrides"))
        m, opt = runner.model, runner.optimizer
        out.append({"exp": str(exp), "mesh": runner.mesh.shape,
                    "local_shapes": {n: tuple(p.shape)
                                     for n, p in m.named_parameters()},
                    "moment_shapes": {
                        n: tuple(opt.inner.state[p]["exp_avg"].shape)
                        for n, p in m.named_parameters()
                        if p in opt.inner.state}})
    return {"calls": out}


# ------------- the sentence-level, self-supervision and class-mapping runners
CLASSES = 5


def _waves(steps: int, b: int, seed: int) -> list:
    """:func:`batches`' waveforms for any ``b`` (an odd one cut from
    ``b + 1``)."""
    return [{k: batch[k][:b] for k in ("waveform", "waveform_len")}
            for batch in batches(steps, b + b % 2, seed=seed)]


def _word_batches(b: int, steps: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for batch in _waves(steps, b, seed):
        lens = rng.integers(1, 6, (b,))
        tokens = rng.integers(1, VOCAB, (b, 5))
        tokens[np.arange(5)[None, :] >= lens[:, None]] = 0
        out.append({**batch, "text": tokens, "text_len": lens})
    return out


def phrase_batch(nums, seed: int) -> dict:
    """A ``VarNumTextCollate`` batch: ``len(nums)`` clips with ``nums[i]``
    phrases each, flattened to ``phrases [ΣN, 4]``."""
    rng = np.random.default_rng(seed)
    b, total = len(nums), int(sum(nums))
    lens = rng.integers(1, 5, (total,))
    tokens = rng.integers(1, VOCAB, (total, 4))
    tokens[np.arange(4)[None, :] >= lens[:, None]] = 0
    pad_index = np.zeros((b, max(nums)), np.int64)
    start = np.cumsum([0] + list(nums))
    for i, n in enumerate(nums):
        pad_index[i, :n] = np.arange(start[i], start[i] + n)
    return {**_waves(1, b, seed)[0], "phrases": tokens,
            "phrases_len": lens, "phrases_num": np.asarray(nums, np.int64),
            "phrases_pad_index": pad_index, "text_key": "phrases"}


def _mapping_batches(steps: int, b: int, strong: bool, seed: int) -> list:
    rng = np.random.default_rng(seed)
    frames = (SAMPLES // 320 + 1) // 4
    out = []
    for item in _waves(steps, b, seed):
        weak = (rng.random((b, CLASSES)) > 0.5).astype(np.float32)
        if strong:
            item["strong_label"] = (rng.random((b, frames, CLASSES)) > 0.6
                                    ).astype(np.float32) * weak[:, None]
            item["weak_label"] = weak
        else:
            item["label"] = weak
        out.append(item)
    return out


def _align(kind: str, dropout):
    from texttoaudiogrounding_tpu_torch.models import (
        AudioTextAlignByPhrase,
        AudioTextAlignByWord,
        Cnn8Rnn,
        EmbeddingAgg,
    )
    from texttoaudiogrounding_tpu_torch.models.align import AlignDotProduct
    from texttoaudiogrounding_tpu_torch.models.sim_pooling import SimPooling

    cls = AudioTextAlignByWord if kind == "word" else AudioTextAlignByPhrase
    return cls(Cnn8Rnn(dropout=dropout), EmbeddingAgg(VOCAB, EMBED),
               AlignDotProduct(), SimPooling("mean", "mean"),
               shared_dim=EMBED, add_proj=True, device="cpu")


def _tagging(dropout):
    from texttoaudiogrounding_tpu_torch.models import Cnn8Rnn
    from texttoaudiogrounding_tpu_torch.models.audio_text_model import (
        AudioTagging,
    )
    return AudioTagging(Cnn8Rnn(dropout=dropout), CLASSES, device="cpu")


def _fit_steps(runner, m, loss_fn, transform, host_batches) -> dict:
    """The runner's ``train_step`` over ``host_batches`` fed as ``fit``
    feeds them: the losses, the first step's gradients and running
    statistics, and the statistics after."""
    from texttoaudiogrounding_tpu_torch.parallel.mesh import device_feed
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_base import (
        whole_batch_inputs,
    )

    first: dict = {}
    first_stats: dict = {}
    hook = runner.post_grad_hook

    def capture(loss, grads):
        hook(loss, grads)
        if not first:
            first.update({n: p.grad.detach().clone()
                          for n, p in m.named_parameters()
                          if p.grad is not None})
            first_stats.update({n: b.clone() for n, b in m.named_buffers()
                                if "running" in n})

    runner.post_grad_hook = capture
    opt = Optimizer({"type": "Adam", "args": {"lr": 1e-3}}, m.parameters(),
                    None)
    losses = [float(runner.train_step(m, loss_fn, opt, batch, transform))
              for batch, _, _ in device_feed(host_batches, runner.mesh, "cpu",
                                             whole=whole_batch_inputs(m))]
    return {"losses": losses, "grads": first, "first_stats": first_stats,
            "stats": {n: b.clone() for n, b in m.named_buffers()
                      if "running" in n}}


def _evaluated(runner, m, host_batch: dict, read):
    """``read(output, model, host batch)`` of the runner's evaluation
    forward (``eval_forward``: on several ranks the batch padded, each
    rank's rows forwarded, the rows gathered) in eval mode."""
    m.eval()
    with torch.no_grad():
        return read(runner.eval_forward(host_batch, m), m, host_batch)


def _runner(cls, mesh):
    runner = cls(device="cpu")
    runner.mesh = mesh
    return runner


def runners(mesh_shape: dict | None = None, f64_stats: bool = True,
            word_weights: str | None = None) -> dict:
    """Two train steps of each of the four runners' steps on seeded
    batches under ``mesh_shape`` (None: one rank), with their outputs of
    an evaluation forward, the self-supervision teacher's weights after
    its broadcast, SpecAugment's stripes, the mixup cases whose pairs span
    two ranks (a forward of 2 clips, the weak class-mapping step at
    B = 6) and the strong step with and without ``trainer.remat``;
    ``word_jax`` is one word-wise step from ``word_weights`` (a state
    dict file) with dropout off, for the JAX comparison."""
    from texttoaudiogrounding_tpu_torch.models import layers

    before = layers.STATS_DTYPE
    layers.STATS_DTYPE = torch.float64 if f64_stats else torch.float32
    try:
        out = _runner_cases(_mesh(mesh_shape), f64_stats)
    finally:
        layers.STATS_DTYPE = before
    if word_weights is not None:
        out["word_jax"] = _word_jax(_mesh(mesh_shape), word_weights)
    return out


def _word_jax(mesh, word_weights: str) -> dict:
    from texttoaudiogrounding_tpu_torch.losses import MaxMarginRankingLoss
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        weak_output_transform,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_weak_sentence import (
        WeakSentenceRunner,
    )

    torch.manual_seed(1)
    m = _align("word", (0.0, 0.0))
    m.load_state_dict(torch.load(word_weights))
    return _fit_steps(_runner(WeakSentenceRunner, mesh), m,
                      MaxMarginRankingLoss(), weak_output_transform,
                      _word_batches(4, 1, seed=21))


def _runner_cases(mesh, f64_stats: bool) -> dict:
    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.losses import (
        ClipBceLoss,
        ClipFrameBceLoss,
        FrameBceLoss,
        MaskedFrameBceLoss,
        MaxMarginRankingLoss,
        RandomTripletLoss,
    )
    from texttoaudiogrounding_tpu_torch.models.layers import (
        rank_stripes,
        spec_augment_stripes,
    )
    from texttoaudiogrounding_tpu_torch.parallel import kernel_shard
    from texttoaudiogrounding_tpu_torch.parallel.mesh import device_feed
    from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
        ClassMappingStrongRunner,
        ClassMappingWeakRunner,
        _mixup_lambdas,
        mapping_strong_output_transform,
        mixup_output_transform,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner,
        strong_output_transform,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseSelfSupervisionRunner,
        weak_output_transform,
    )
    from texttoaudiogrounding_tpu_torch.training.runner_weak_sentence import (
        WeakSentenceRunner,
    )

    out: dict = {}
    # sentence level, word- and phrase-wise (ΣN 6, then 5: divisible by
    # the two ranks and not), then an evaluation forward of 3 clips (padded
    # to the ranks; the phrase batch's ΣN = B = 3)
    for kind, loss_fn, host in (
            ("word", MaxMarginRankingLoss(), _word_batches(4, 2, seed=11)),
            ("phrase", RandomTripletLoss(), [phrase_batch([1, 2, 1, 2], 12),
                                             phrase_batch([2, 1, 1, 1], 13)])):
        torch.manual_seed(1)
        m = _align(kind, (0.2, 0.5))
        m.load_state_dict(random_state_dict(m, 3))
        runner = _runner(WeakSentenceRunner, mesh)
        evaluated = (_word_batches(3, 1, seed=14)[0] if kind == "word"
                     else phrase_batch([1, 1, 1], 15))
        tracks = _evaluated(runner, m, evaluated, runner.eval_tracks)
        res = _fit_steps(runner, m, loss_fn, weak_output_transform, host)
        out[f"sentence_{kind}"] = {**res, "tracks": tracks}
    # self-supervision: each rank builds its teacher from another seed;
    # rank 0's weights reach every rank
    torch.manual_seed(1)
    m = model(weak=True)
    runner = _runner(WeakPhraseSelfSupervisionRunner, mesh)
    runner.config = {"teacher": {
        "type": "MultiTextBiEncoder",
        "args": {"shared_dim": EMBED, "add_proj": True},
        "audio_encoder": {"type": "Cnn8Rnn", "args": {}},
        "text_encoder": {"type": "EmbeddingAgg",
                         "args": {"vocab_size": VOCAB, "embed_dim": EMBED}},
        "match_fn": {"type": "DotProduct", "args": {}}}}
    torch.manual_seed(100 + mesh.rank)
    teacher = runner.build_teacher()
    torch.manual_seed(1)
    res = _fit_steps(runner, m, ClipFrameBceLoss(
                         0.5, clip_label_key="label",
                         frame_label_key="frame_label"),
                     runner.teacher_transform(teacher),
                     batches(2, phrases=3, seed=16))
    res["teacher"] = {k: v.clone() for k, v in teacher.state_dict().items()}
    out["selfsup"] = res
    # class mapping: weak with mixup and SpecAugment, strong
    for kind in ("weak", "strong"):
        torch.manual_seed(1)
        m = _tagging((0.2, 0.5))
        m.load_state_dict(random_state_dict(m, 4))
        strong = kind == "strong"
        runner = _runner(ClassMappingStrongRunner if strong
                         else ClassMappingWeakRunner, mesh)
        evaluated = _mapping_batches(1, 3, strong, seed=18)[0]
        scores = _evaluated(runner, m, evaluated, lambda out, *_: {
            k: v for k, v in out.items() if torch.is_tensor(v)})
        if strong:
            res = _fit_steps(runner, m, MaskedFrameBceLoss(),
                             mapping_strong_output_transform,
                             _mapping_batches(2, 4, True, seed=19))
        else:
            runner.static_train_inputs = {"specaug": True}
            host = _mapping_batches(2, 4, False, seed=17)
            mix = np.random.RandomState(1235)
            for batch in host:
                batch["mixup_lambda"] = _mixup_lambdas(mix, 4)
            res = _fit_steps(runner, m, ClipBceLoss(), mixup_output_transform,
                             host)
        out[f"mapping_{kind}"] = {**res, "eval": scores}
    # SpecAugment's stripes for 4 clips of 21 frames as a rank draws them
    gen = torch.Generator().manual_seed(9)
    with kernel_shard.data_parallel(mesh):
        rows = kernel_shard.global_rows(4 // (mesh.axis_size("data")))
        out["stripes"] = rank_stripes(spec_augment_stripes(gen, rows, 21,
                                                           64))
    # mixup over two clips: one row a rank on two ranks, the pair spanning
    # them (one rank holds the mixed row, the other none)
    m = _tagging((0.0, 0.0))
    m.load_state_dict(random_state_dict(m, 6))
    m.train()
    host = _mapping_batches(1, 2, False, seed=22)[0]
    host["mixup_lambda"] = np.array([0.3, 0.7], np.float32)
    batch, _, _ = next(device_feed([host], mesh, "cpu"))
    with torch.no_grad(), kernel_shard.data_parallel(mesh):
        forward = m(batch)
    out["odd_mixup"] = {k: forward[k].clone() for k in ("clip_sim",
                                                        "length")}
    # the weak class-mapping step at B = 6: three rows a rank on two
    # ranks, the pair (2, 3) spanning them
    torch.manual_seed(1)
    m = _tagging((0.2, 0.5))
    m.load_state_dict(random_state_dict(m, 4))
    runner = _runner(ClassMappingWeakRunner, mesh)
    runner.static_train_inputs = {"specaug": True}
    host = _mapping_batches(2, 6, False, seed=23)
    mix = np.random.RandomState(1236)
    for batch in host:
        batch["mixup_lambda"] = _mixup_lambdas(mix, 6)
    out["mapping_weak_b6"] = _fit_steps(runner, m, ClipBceLoss(),
                                        mixup_output_transform, host)
    # the strong step with and without trainer.remat
    for remat in (False, True):
        torch.manual_seed(1)
        m = model()
        runner = _runner(StrongRunner, mesh)
        runner.config = {"trainer": {"remat": remat}}
        out[f"strong_remat_{remat}"] = _fit_steps(
            runner, m, FrameBceLoss(), strong_output_transform,
            batches(2, seed=24))
    return out


JOBS = {"steps": steps, "bn_pool": bn_pool, "clip": clip, "runs": runs,
        "runners": runners}


if __name__ == "__main__":
    main(sys.argv[1])
