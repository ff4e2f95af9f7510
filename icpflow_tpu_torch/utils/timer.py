"""Section timers and a profiler trace helper.

Port of ``icpflow_tpu/utils/timer.py``, the replacement for the reference's
wall-clock context timer (`utils_timer.py:22-69`) and CUDA-event timer
(`hist_cuda/timer.py:10-86`): a section timer that waits for the card at
each section's edges, so that a section holds the device work it queued,
and a thin wrapper over ``torch.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class SectionTimer:
    """Accumulating named-section timer. With ``sync`` and a usable GPU it
    calls ``torch.cuda.synchronize()`` at both edges of every section."""

    def __init__(self, sync: bool = True):
        self.sync = sync and torch.cuda.is_available()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t:8.3f}s  ({c} calls, "
                         f"{1000.0 * t / max(c, 1):8.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """``torch.profiler`` trace of the block (CPU, and CUDA where a GPU is
    usable) written to ``logdir`` for TensorBoard; a no-op when ``logdir``
    is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
