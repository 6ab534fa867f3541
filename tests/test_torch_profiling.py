"""The port's profiling utilities against the JAX package's, on the CPU:
StepTimer on the same clock readings, and the torch.profiler trace (a
Chrome trace holding the block's operations and its annotated regions;
the card by default, raising without one)."""

import json
import time

import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

from ppgs_tpu.utils import profiling as jax_profiling

from ppgs_tpu_torch.utils import profiling


@pytest.mark.parametrize('warmup,steps', [(0, 1), (2, 5), (5, 3)])
def test_step_timer_matches_jax(monkeypatch, warmup, steps):
    """Both timers read the same clock (a seeded sequence of readings):
    the same times and summary, the warm-up steps left out unless they are
    all there is."""
    readings = [0.0]
    for i in range(2 * steps):
        readings.append(readings[-1] + 0.01 * (1 + (i * 7) % 5))
    summaries, times = [], []
    for module in (jax_profiling, profiling):
        clock = iter(readings)
        monkeypatch.setattr(time, 'perf_counter', lambda: next(clock))
        timer = module.StepTimer(warmup=warmup)
        for _ in range(steps):
            with timer:
                pass
        summaries.append(timer.summary())
        times.append(timer.times)
    assert times[1] == times[0]
    assert summaries[1] == summaries[0]
    assert summaries[1]['steps'] == steps


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / 'trace', device='cpu') as log_dir:
        with profiling.annotate('ppgs_block'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == tmp_path / 'trace'
    path = profiling.trace.path
    assert path.parent == log_dir and path.suffix == '.json'
    names = {event.get('name') for event in
             json.loads(path.read_text())['traceEvents']}
    assert 'ppgs_block' in names and 'aten::mm' in names


def test_trace_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without device the trace records the card's kernels too; without a
    card it raises before recording, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(tmp_path):
            pass
    assert not any(tmp_path.iterdir())
    assert isinstance(profiling.annotate('x'), torch.profiler.record_function)
