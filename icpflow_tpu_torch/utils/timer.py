"""A profiler trace helper.

Port of ``icpflow_tpu/utils/timer.py``'s trace helper: a thin wrapper over
``torch.profiler`` traces. Stage and span times of a call come from
``icpflow_tpu_torch.trace`` (``timings=`` on the entry points), which also
names every span in such a trace.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


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
