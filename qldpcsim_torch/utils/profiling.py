"""Timing and tracing utilities (port of `qldpcsim_tpu/utils/profiling.py`)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


class Timer:
    """Wall-clock timer context manager (the host's clock: synchronize the
    device before leaving the block when it times device work)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


class ThroughputMeter:
    """Decoded-shots/s meter with running totals."""

    def __init__(self):
        self.shots = 0
        self.seconds = 0.0

    def add(self, shots: int, seconds: float):
        self.shots += shots
        self.seconds += seconds

    @property
    def shots_per_s(self) -> float:
        return self.shots / self.seconds if self.seconds else float("nan")


@contextlib.contextmanager
def trace_context(name: str, trace_dir: Optional[str] = None,
                  device_only: bool = False):
    """`torch.profiler` trace scope: records CPU activity, and CUDA activity
    when torch sees a card, under the range `name`, and writes
    `<trace_dir>/<name>.trace.json` (Chrome trace format; open it in
    Perfetto or chrome://tracing). With `device_only` it records the card's
    activity alone (kernels and copies: the host's operators are not
    recorded, which keeps the trace's own cost small). Yields the profiler;
    a no-op yielding None when trace_dir is None."""
    if trace_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(trace_dir, exist_ok=True)
    activities = [] if device_only else [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.trace.json"))
