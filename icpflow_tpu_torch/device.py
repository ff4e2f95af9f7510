"""The device an entry point runs on: the GPU unless the caller names another.

Every engine and state constructor of the package takes ``device="cuda"`` by
default. ``device="cpu"`` selects the plain PyTorch versions of the kernels
(the CPU tests do). Nothing falls back: asking for a GPU where none is
usable raises.
"""

from __future__ import annotations

import torch

from .trace import StageClock  # noqa: F401  (re-exported)

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
