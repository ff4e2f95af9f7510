"""Reads a profiled stretch of whole calls from ``torch.profiler`` into a
few aggregates, in memory (no trace file is written): the device's busy
time as the union of its activity intervals, its kernels by count and by
name, the NN kernel's time, and the idle gaps by the harness span the host
was in (``bench.<layer>`` record_function spans; the ``bench.call`` span
wraps one call). A gap inside a call but outside the layer spans is
``after_<layer>`` (``after_flow``: the copies out) or ``entry`` before the
first; one between calls is ``harness``."""

from __future__ import annotations

import bisect
import collections

from . import stats

NN_KERNELS = ("masked_nn_kernel", "nn_finish_kernel")
TOP = 10


def _short(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.split("(")[0].strip()
    return name[:120]


def summarize(events, cuda_type) -> dict:
    """``events``: the profiler's kineto events (``name()``,
    ``device_type()``, ``is_user_annotation()``, ``start_ns()``,
    ``duration_ns()``); ``cuda_type``: the device type of the card's
    activities."""
    device, spans, calls = [], [], []
    for e in events:
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == cuda_type:
            # a record_function range is mirrored on the device's timeline
            # as an annotation that covers its activities: no activity
            if not (name.startswith("bench.") or e.is_user_annotation()):
                device.append((s, t, name))
        elif name == "bench.call":
            calls.append((s, t))
        elif name.startswith("bench."):
            spans.append((s, t, name[6:]))
    return reduce(device, spans, calls)


def _pieces(gaps, cuts):
    """(start, end, midpoint) of the gaps, split where a span or a call
    begins or ends."""
    for g0, g1 in gaps:
        inner = cuts[bisect.bisect_right(cuts, g0):bisect.bisect_left(cuts, g1)]
        edges = [g0, *inner, g1]
        for a, b in zip(edges, edges[1:]):
            yield a, b, (a + b) / 2


def reduce(device, spans, calls) -> dict:
    """The aggregates of device intervals (start, end, name), harness
    spans (start, end, layer) and call spans (start, end), in ns."""
    if not calls:
        return {}
    calls.sort()
    t0, t1 = calls[0][0], max(c[1] for c in calls)
    inside = [(max(s, t0), min(t, t1), n) for s, t, n in device
              if t > t0 and s < t1]
    busy = stats.union_length([(s, t) for s, t, _ in inside])
    by_name = collections.Counter()
    kernels = 0
    nn_ns = 0
    for s, t, n in inside:
        by_name[_short(n)] += t - s
        if not n.startswith(("Memcpy", "Memset")):
            kernels += 1
        if any(k in n for k in NN_KERNELS):
            nn_ns += t - s
    spans.sort()
    starts = [s for s, _, _ in spans]
    call_starts = [c[0] for c in calls]
    cuts = sorted({x for s, t, _ in spans for x in (s, t)}
                  | {x for c in calls for x in c})
    idle = collections.Counter()
    for g0, g1, mid in _pieces(stats.gaps([(s, t) for s, t, _ in inside],
                                          t0, t1), cuts):
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and spans[i][1] >= mid:
            label = spans[i][2]
        else:
            c = bisect.bisect_right(call_starts, mid) - 1
            if c >= 0 and calls[c][1] >= mid:
                label = ("after_" + spans[i][2]
                         if i >= 0 and spans[i][0] >= calls[c][0]
                         else "entry")
            else:
                label = "harness"
        idle[label] += g1 - g0
    return {
        "calls": len(calls),
        "window_s": (t1 - t0) * 1e-9,
        "busy_s": busy * 1e-9,
        "kernels": kernels,
        "nn_kernel_s": nn_ns * 1e-9,
        "device_ops": [[n, v * 1e-9] for n, v in by_name.most_common(TOP)],
        "idle_gaps": [[n, v * 1e-9] for n, v in idle.most_common(TOP)],
    }
