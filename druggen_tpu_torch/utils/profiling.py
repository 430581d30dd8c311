"""Profiling / tracing utilities (port of ``druggen_tpu/utils/profiling.py``).

The reference has no profiling beyond wall-clock strings
(``src/util/utils.py:303-305``).  :func:`trace` records a region with
``torch.profiler`` (the host and, where a card is present, its kernels)
and writes a Chrome trace, viewable in Perfetto or ``chrome://tracing``, as
the JAX package's ``jax.profiler.trace`` writes an XLA trace for
TensorBoard.  :class:`StepTimer` is copied from the JAX module.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed region and write ``<log_dir>/trace_<time>_<pid>
    .json`` (Chrome trace format) when it ends; yields the
    ``torch.profiler.profile`` (for ``key_averages()``).

    No-op (yields None) when log_dir is falsy, so callers can
    unconditionally wrap their hot region and gate with a flag."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


class StepTimer:
    """Exponential-moving-average step timer with percentile capture."""

    def __init__(self, ema: float = 0.9, keep: int = 1000):
        self.ema = ema
        self.avg: float | None = None
        self.samples: list[float] = []
        self.keep = keep
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else (
            self.ema * self.avg + (1 - self.ema) * dt)
        self.samples.append(dt)
        if len(self.samples) > self.keep:
            del self.samples[: len(self.samples) - self.keep]
        return False

    def stats(self) -> dict:
        if not self.samples:
            return {}
        ss = sorted(self.samples)
        n = len(ss)
        return {
            "step_avg_s": self.avg,
            "step_p50_s": ss[n // 2],
            "step_p90_s": ss[min(int(n * 0.9), n - 1)],
            "step_p99_s": ss[min(int(n * 0.99), n - 1)],
        }
