"""What the readers of the program's own spans and counters share.

The program keeps its last traced calls in memory
(``icpflow_tpu_torch.trace.calls()``). A traced window passes ``timings``
to every call, and each call leaves one record whose root span is the
entry's ``root`` (``record["root"]``), so the window's calls are the last
``record["calls"]`` the program kept. Time and counter metrics are means
over the unprofiled calls, which the profiler does not slow, a call
without the span or the counter counting 0 (as ``readings.stage_ms``);
the NN roofline reads the profiled calls, whose kernels the profile
timed. Each function returns None where its record holds nothing to
read: another entry's record, an untraced run, or a program that keeps
no trace of its calls.
"""

from __future__ import annotations

import importlib.util
import pathlib

from . import readings

NN_VALID = "nn_valid."


def window_calls(rec: dict, entry: str, profiled: bool = False):
    """The program's records of the window's calls into ``entry``,
    profiled or not; None where there are none."""
    if rec.get("entry") != entry or not rec.get("stages"):
        return None
    try:
        from icpflow_tpu_torch import trace
    except ImportError:
        return None
    kept = [c for c in trace.calls()[-int(rec["calls"]):]
            if c.entry == rec["root"] and c.profiled == profiled]
    return kept or None


def span_ms(rec: dict, entry: str, name: str):
    """Mean host milliseconds a call in span ``name`` (all its runs)."""
    calls = window_calls(rec, entry)
    if calls is None:
        return None
    total = sum(c.spans[name].total_ns for c in calls if name in c.spans)
    return total / len(calls) * 1e-6


def counter(rec: dict, entry: str, name: str):
    """Mean of counter ``name`` a call."""
    calls = window_calls(rec, entry)
    if calls is None:
        return None
    return sum(c.counters.get(name, 0) for c in calls) / len(calls)


def host_syncs(rec: dict, entry: str):
    """Mean synchronizing CUDA calls a call, over all its spans; None
    where the calls ran on no CUDA device (nothing counts them there)."""
    calls = window_calls(rec, entry)
    if calls is None or any(c.device != "cuda" for c in calls):
        return None
    return sum(sum(c.syncs.values()) for c in calls) / len(calls)


def _nn_bound():
    path = pathlib.Path(__file__).resolve().parent / "layers" / "nn_bound.py"
    spec = importlib.util.spec_from_file_location("bench_nn_bound", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nn_roofline(rec: dict, entry: str):
    """Percent of its bound the NN kernel reached over the profiled calls:
    the least time the card could take for their valid (src, dst)
    candidates (``layers/nn_bound.py``, per form and output) over the
    profile's NN kernel time."""
    prof = readings.profile(rec, entry)
    if prof is None or prof["nn_kernel_s"] <= 0:
        return None
    calls = window_calls(rec, entry, profiled=True)
    if calls is None or len(calls) != prof["calls"]:
        return None
    nb = _nn_bound()
    bound = 0.0
    for c in calls:
        for name, valid in c.counters.items():
            if name.startswith(NN_VALID):
                form, output = name[len(NN_VALID):].split(".")
                bound += nb.bound_ms(valid, form, output == "points")
    return 100.0 * bound / (prof["nn_kernel_s"] * 1e3)
