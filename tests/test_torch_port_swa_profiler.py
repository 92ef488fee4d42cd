"""The port's stochastic weight averaging and step profiler.

* ``SWAState`` against the JAX package's over three updates of a model's
  parameters and BatchNorm statistics (the integer ``num_batches_tracked``
  left out): the average within 1e-6 relative (the same f32 operations),
  a copy at n = 0, and ``apply_to`` puts it into a model;
* ``StepProfiler`` writes a Chrome trace of the chosen steps on the CPU
  (host operators), ends a trace that an epoch cuts short, and writes
  nothing without ``trainer.profile``; ``ThroughputMeter``'s line has the
  JAX meter's form.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texttoaudiogrounding_tpu.training import profiling as jprofiling
from texttoaudiogrounding_tpu.training.swa import SWAState as JSWAState
from texttoaudiogrounding_tpu.training.train_state import TrainState
from texttoaudiogrounding_tpu_torch.models.layers import CDurBlock
from texttoaudiogrounding_tpu_torch.training.profiling import (
    StepProfiler,
    ThroughputMeter,
)
from texttoaudiogrounding_tpu_torch.training.swa import SWAState


def _set_random(model, rng) -> dict:
    """Fill ``model``'s state with random values; return its floating
    state as numpy arrays."""
    with torch.no_grad():
        for name, value in model.state_dict().items():
            if value.is_floating_point():
                value.copy_(torch.from_numpy(rng.uniform(
                    0.1, 2.0, value.shape).astype(np.float32)))
            else:
                value.add_(1)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if v.is_floating_point()}


def _jax_state(state: dict) -> TrainState:
    return TrainState(
        params={k: jnp.asarray(v) for k, v in state.items()
                if "running" not in k},
        batch_stats={k: jnp.asarray(v) for k, v in state.items()
                     if "running" in k}, opt_state=None, step=0)


def test_swa_matches_jax_over_three_updates():
    rng = np.random.default_rng(0)
    model = CDurBlock(3, 4)
    state = _set_random(model, rng)
    swa, jswa = SWAState.create(model), JSWAState.create(_jax_state(state))
    assert "bn.num_batches_tracked" not in swa.average
    assert set(swa.average) == set(state)
    for _ in range(3):
        state = _set_random(model, rng)
        swa = swa.update(model)
        jswa = jswa.update(_jax_state(state))
        ref = {**jswa.params, **jswa.batch_stats}
        for name, avg in swa.average.items():
            np.testing.assert_allclose(avg.numpy(), np.asarray(ref[name]),
                                       rtol=1e-6, err_msg=name)
    assert swa.n_averaged == int(jswa.n_averaged) == 3
    # the first update replaced the copy made at n = 0
    first = SWAState.create(model)
    _set_random(model, rng)
    latest = {k: v.clone() for k, v in model.state_dict().items()}
    first.update(model)
    assert all(torch.equal(first.average[k], latest[k])
               for k in first.average)
    target = swa.apply_to(CDurBlock(3, 4))
    for name, value in target.state_dict().items():
        if name in swa.average:
            assert torch.equal(value, swa.average[name]), name


def _steps(profiler, n: int, start: int = 0) -> None:
    x = torch.ones(8, 8)
    for i in range(start, start + n):
        profiler.step(i)
        x = torch.relu(x @ x / 8.0)


def test_step_profiler_writes_a_trace_on_the_cpu(tmp_path):
    prof = StepProfiler({"start_step": 1, "num_steps": 2}, tmp_path, "cpu")
    _steps(prof, 5)
    prof.close(5)
    assert prof.traces == [tmp_path / "profile" / "steps_1-2.json"]
    events = json.loads(prof.traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::relu" for e in events)
    # an epoch of 4 steps cuts a trace of steps 3-7 at step 4
    cut = StepProfiler({"start_step": 3, "num_steps": 5}, tmp_path / "b",
                       "cpu")
    _steps(cut, 4)
    cut.close(4)
    assert [p.name for p in cut.traces] == ["steps_3-3.json"]
    off = StepProfiler(None, tmp_path / "c", "cpu")
    _steps(off, 4)
    off.close(4)
    assert not off.traces and not (tmp_path / "c").exists()


def test_throughput_line_has_the_jax_form():
    form = re.compile(r"^\d+\.\d samples/s, \d+\.\d\d steps/s$")
    for meter in (ThroughputMeter(), jprofiling.ThroughputMeter()):
        meter.update(32)
        meter.update(32)
        assert meter.samples == 64 and meter.steps == 2
        assert form.match(meter.summary()), meter.summary()


@pytest.mark.parametrize("config, start, num", [
    ({"num_steps": 4}, 2, 4), ({"start_step": 0}, 0, 3), ({}, 2, 3)])
def test_step_profiler_reads_the_jax_defaults(tmp_path, config, start, num):
    ours = StepProfiler(config, tmp_path, "cpu")
    theirs = jprofiling.StepProfiler(config, tmp_path)
    assert (ours.start, ours.num, ours.enabled) == (
        theirs.start, theirs.num, theirs.enabled) == (start, num,
                                                      bool(config))
