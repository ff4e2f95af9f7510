"""The device an entry point runs on: the GPU unless the caller names another.

Every engine and state constructor of the package takes ``device="cuda"`` by
default. ``device="cpu"`` selects the plain PyTorch versions of the kernels
(the CPU tests do). Nothing falls back: asking for a GPU where none is
usable raises.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``. Raises ``RuntimeError`` for a CUDA
    device on a machine where ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device=\"cpu\" for the plain PyTorch versions")
    return dev


class StageClock:
    """Per-stage milliseconds into ``out``: CUDA events on a CUDA device
    (read after one synchronize at the end), host clock on the CPU."""

    def __init__(self, out: Optional[dict], device: torch.device):
        self.out = out
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: str):
        if self.out is None:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def finish(self):
        if self.out is None or not self.marks:
            return
        if self.cuda:
            torch.cuda.synchronize()
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            self.out[name] = (a.elapsed_time(b) if self.cuda
                              else (b - a) * 1e3)
