"""The step profiler and the throughput meter of the trainer's epoch log.

Port of ``texttoaudiogrounding_tpu/training/profiling.py:16-78``: the JAX
package traces chosen training steps with ``jax.profiler``; here
``torch.profiler`` traces them, and writes a Chrome trace (open it in
``chrome://tracing`` or Perfetto) into ``exp_dir/profile/``.  The
profiler records the card's activity (kernels, copies) when the model is
on the card, and the host's operators only when it runs on the CPU.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch


class StepProfiler:
    """Traces steps ``[start_step, start_step + num_steps)`` of training
    (``trainer.profile: {start_step, num_steps}``, default 2 and 3; no
    ``profile`` key, no trace) into ``exp_dir/profile/steps_<a>-<b>.json``;
    a trace open at the end of an epoch ends there, as in the JAX fit."""

    def __init__(self, config: dict | None, exp_dir, device: torch.device):
        config = config or {}
        self.start = config.get("start_step", 2)
        self.num = config.get("num_steps", 3)
        self.enabled = bool(config)
        self.log_dir = Path(exp_dir) / "profile"
        self.device = torch.device(device)
        self._prof = None
        self._first = 0
        self.traces: list[Path] = []

    def step(self, iteration: int) -> None:
        """Call before training step ``iteration`` (counted over the
        run)."""
        if not self.enabled:
            return
        if iteration == self.start:
            act = torch.profiler.ProfilerActivity
            self._prof = torch.profiler.profile(activities=[
                act.CUDA if self.device.type == "cuda" else act.CPU])
            self._prof.start()
            self._first = iteration
        elif self._prof is not None and iteration >= self.start + self.num:
            self._stop(iteration)

    def _stop(self, end: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / f"steps_{self._first}-{end - 1}.json"
        self._prof.export_chrome_trace(str(path))
        self.traces.append(path)
        self._prof = None

    def close(self, iteration: int) -> None:
        """End an open trace; ``iteration`` is the next step's."""
        if self._prof is not None:
            self._stop(iteration)


class ThroughputMeter:
    """Samples/s and steps/s since the last reset, for the epoch log."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.samples = 0
        self.steps = 0
        self.t0 = time.time()

    def update(self, batch_size: int) -> None:
        self.samples += batch_size
        self.steps += 1

    def summary(self) -> str:
        dt = max(time.time() - self.t0, 1e-9)
        return (f"{self.samples / dt:.1f} samples/s, "
                f"{self.steps / dt:.2f} steps/s")
