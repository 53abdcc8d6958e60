"""Stage timing, running metric means and device tracing (port of
`sam6d_tpu/core/profiling.py`).

The reference times each stage by the wall clock around
`torch.cuda.synchronize` (T_data / T_forward / T_back, solver.py:82-110);
`StageTimer` does so too, so a stage's time is the card's, not the time to
queue its work. `device_trace` captures a `torch.profiler` trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates per-stage wall-clock; on a CUDA device the card is
    synchronized at each stage's end."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds a call of each stage."""
        return {k: self.times[k] / max(self.counts[k], 1) for k in self.times}


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """torch.profiler trace (CPU and CUDA activity) around a region, written
    as a Chrome trace into `logdir`; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class LogBuffer:
    """Running means of scalar metrics (reference gorilla LogBuffer used by
    Solver, utils/solver.py:111-121)."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1

    def average(self) -> Dict[str, float]:
        return {k: self._sums[k] / self._counts[k] for k in self._sums}

    def clear(self):
        self._sums.clear()
        self._counts.clear()
