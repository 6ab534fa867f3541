"""Tracing and per-step timing; the counterpart of
``ppgs_tpu/utils/profiling.py`` on ``torch.profiler``.

The reference has no profiler hooks (SURVEY.md §5). ``trace`` records a
block's CPU operations and, on the card, its CUDA kernels, and writes a
Chrome trace (view it in Perfetto or chrome://tracing); ``annotate`` names
a region in it; ``StepTimer`` times steps on the host's clock.
"""

import contextlib
import os
import tempfile
import time
from pathlib import Path

import torch

from .. import devices


@contextlib.contextmanager
def trace(log_dir=None, device=None):
    """Capture a torch.profiler trace around a code block and write it as
    ``{log_dir}/trace.{pid}.{ns}.json`` (Chrome trace format).

    ``device``: None means the card, whose CUDA kernels are recorded beside
    the CPU's operations; without a card it raises unless the caller names
    the CPU (``device='cpu'``: the CPU's operations only). ``log_dir``
    defaults to ``ppgs_tpu_torch_trace`` in the temporary directory.
    Yields the directory; the file's path is ``trace.path`` after the block.
    """
    device = devices.resolve(device)
    log_dir = Path(log_dir or Path(tempfile.gettempdir())
                   / 'ppgs_tpu_torch_trace')
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        yield log_dir
    finally:
        profiler.stop()
        path = log_dir / f'trace.{os.getpid()}.{time.time_ns()}.json'
        profiler.export_chrome_trace(str(path))
        trace.path = path


class StepTimer:
    """Wall-clock per-step timing with warmup-aware summaries."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._start)

    def summary(self):
        steady = self.times[self.warmup:] or self.times
        return {
            'steps': len(self.times),
            'mean_s': sum(steady) / max(len(steady), 1),
            'min_s': min(steady, default=0.0),
            'max_s': max(steady, default=0.0),
        }


def annotate(name):
    """Named trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)
