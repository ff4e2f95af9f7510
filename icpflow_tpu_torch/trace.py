"""Stage times, spans and counters of a traced call.

A call of an entry point (``pipeline.run_frame_pair``,
``SceneFlowEngine.run_pair``, ``StreamingEngine.process``,
``cli.run_sample``, the offline CLI's per-pair and per-sample steps) is
traced when its caller passes a ``timings`` dict. Its outermost :class:`StageClock` then opens the call's
trace and makes it current for the thread; an inner clock (hdbscan's, the
CLI's, the datasets') joins the trace that is current. Every stage becomes
a span ``icpflow.<stage>``, and the call itself a root span
``icpflow.<entry>``. Code below the stages adds spans with :func:`span`
and counts with :func:`count`. While a CUDA graph is captured,
:func:`recording` sets the thread's call aside and keeps what the captured
code counts, so that :func:`recount` can add it to the call that replays
the graph, once a replay.

The ledger of kernel calls: each call of a kernel's implementation, a
hand-written launch or its plain version, is one :func:`launch` (kernel
name, shape), counted for the process, traced or not, and in a traced call
as ``launches.<kernel>``; under :func:`recording` in the recording only,
which :func:`recount` adds as if the replay had launched it.

Untraced, a kernel call costs one update of the ledger, and nothing else
here costs more than an attribute read: :func:`span` returns one shared
no-op context, :func:`count` returns at once, and no ``record_function``,
CUDA event, tensor, device op or sync is added.

Traced, a span takes its times from the host clock (``perf_counter_ns``):
a span's time is the host's time in it, waits at syncs inside it included.
The stage times written into ``timings`` keep their CUDA events. While
``torch.profiler`` records, every span is also a ``record_function`` range
of the same name, so the profiler's trace shows them on its own clock. On
a CUDA device the call runs under ``torch.cuda.set_sync_debug_mode("warn")``
and every synchronizing CUDA call is counted (``host_syncs``) and charged
to the innermost open span; the warnings are not shown, and the mode and
the warning filters are restored when the call ends. A count given as a
tensor (the NN sweeps' valid candidates) is added up on the device and
read once when the call ends.

For an operator: :func:`calls` returns the last :data:`RING` traced calls
of the process as :class:`CallRecord`\\ s (per span name: count, total and
self nanoseconds, parents; the counters; the syncs per span), oldest
first; :func:`clear` empties them. Nothing is written to disk: run under
``torch.profiler`` to export the spans.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time
import warnings
from typing import Optional

import torch

RING = 1024                 # traced calls kept
SYNC_WARNING = "called a synchronizing CUDA operation"
# torch's notice on setting the mode: it "does not yet detect all
# synchronizing operations", so ``host_syncs`` is a lower bound
PROTOTYPE_NOTICE = "Synchronization debug mode is a prototype"
ROOT = ""                   # parent name of a root span


class _Null:
    """The no-op context :func:`span` returns when no call is traced."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Local(threading.local):
    call = None             # the thread's open _Call


_local = _Local()
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_launches: collections.Counter = collections.Counter()   # (kernel, shape)


@dataclasses.dataclass
class SpanStats:
    """One span name within a call: how often it ran, its host time, its
    time less that of its child spans, and how often each parent span name
    held it (:data:`ROOT` for the call's root)."""
    count: int = 0
    total_ns: int = 0
    self_ns: int = 0
    parents: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


@dataclasses.dataclass
class CallRecord:
    """One traced call. ``entry``: the root span's name less ``icpflow.``
    (``pair``, ``frame``, ...); ``device``: its device type (host syncs
    are counted on ``cuda`` only); ``profiled``: whether ``torch.profiler``
    was recording when the call began; ``counters``: name -> total
    (``icp_iters``, ``ego_iters``, ``match_pairs``, ``offline_pairs``,
    ``score_points``, ``host_syncs``, ``nn_valid.<form>.<index|points>``,
    ``launches.<kernel>``, ``icp_graph_captures``, ``icp_graph_replays``,
    ``dbscan_rounds``, ``dbscan_points``, ``dbscan_slots``);
    ``syncs``: span name -> host
    syncs while it was the innermost open span."""
    id: int
    entry: str
    device: str
    profiled: bool
    start_ns: int
    end_ns: int
    spans: dict
    counters: collections.Counter
    syncs: collections.Counter


class _Span:
    __slots__ = ("name", "parent", "t0", "child_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _local.call.open(self)
        return self

    def __exit__(self, *exc):
        call = _local.call
        if call is not None:
            call.close(self)
        return False


class _Call:
    """The open trace of one call."""

    def __init__(self, entry: str, device: torch.device):
        self.stack = []
        self.pending = collections.defaultdict(list)
        self.record = CallRecord(
            id=next(_ids), entry=entry, device=device.type,
            profiled=bool(torch.autograd.profiler._is_profiler_enabled),
            start_ns=time.perf_counter_ns(), end_ns=0, spans={},
            counters=collections.Counter(), syncs=collections.Counter())
        self.sync_state = None
        if device.type == "cuda":
            filters = warnings.catch_warnings()
            filters.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.filterwarnings("ignore", message=PROTOTYPE_NOTICE)
            shown = warnings.showwarning
            warnings.showwarning = self._show
            self.sync_state = (filters, shown,
                               torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode("warn")
        self.root = _Span("icpflow." + entry)
        self.open(self.root)

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if str(message).startswith(SYNC_WARNING):
            call = _local.call
            if call is not None:
                top = call.stack[-1].name if call.stack else call.root.name
                call.record.syncs[top] += 1
            return
        self.sync_state[1](message, category, filename, lineno, file, line)

    def open(self, s: _Span):
        s.parent = self.stack[-1] if self.stack else None
        s.child_ns = 0
        s.range = None
        if self.record.profiled:
            s.range = torch.autograd.profiler.record_function(s.name)
            s.range.__enter__()
        self.stack.append(s)
        s.t0 = time.perf_counter_ns()

    def close(self, s: _Span):
        t1 = time.perf_counter_ns()
        if s not in self.stack:
            return
        while self.stack[-1] is not s:       # left open by an inner raise
            self.close(self.stack[-1])
        self.stack.pop()
        if s.range is not None:
            s.range.__exit__(None, None, None)
        dur = t1 - s.t0
        st = self.record.spans.get(s.name)
        if st is None:
            st = self.record.spans[s.name] = SpanStats()
        st.count += 1
        st.total_ns += dur
        st.self_ns += dur - s.child_ns
        st.parents[ROOT if s.parent is None else s.parent.name] += 1
        if s.parent is not None:
            s.parent.child_ns += dur

    def end(self, keep: bool):
        """Closes the root, restores the sync mode and the warning filters,
        reads the device counts and keeps the record (``keep``)."""
        self.close(self.root)
        if self.sync_state is not None:
            filters, _, mode = self.sync_state
            torch.cuda.set_sync_debug_mode(mode)
            filters.__exit__(None, None, None)
        _local.call = None
        if not keep:
            return
        rec = self.record
        if self.pending:
            names = list(self.pending)
            sums = torch.stack([torch.cat(self.pending[n]).sum()
                                for n in names]).tolist()
            rec.counters.update(dict(zip(names, sums)))
        total = sum(rec.syncs.values())
        if total:
            rec.counters["host_syncs"] = total
        rec.end_ns = time.perf_counter_ns()
        _ring.append(rec)


def current() -> Optional[_Call]:
    """The thread's traced call, or None."""
    return _local.call


def span(name: str):
    """A context that times the block as span ``name`` of the traced call;
    untraced, one shared no-op context."""
    if _local.call is None:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if _local.call is None:
                return fn(*args, **kw)
            with _Span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, n=1):
    """Adds ``n`` to counter ``name`` of the traced call; untraced, returns
    at once. A tensor ``n`` is added up on its device and read once when
    the call ends."""
    call = _local.call
    if call is None:
        return
    if isinstance(n, torch.Tensor):
        call.pending[name].append(n.reshape(-1))
    else:
        call.record.counters[name] += n


class Recorded:
    """What code under :func:`recording` counted: ``counters`` (name ->
    total of the numbers), ``pending`` (name -> the tensors, each
    flattened, which a CUDA graph's replay overwrites) and ``launches``
    ((kernel, shape) -> kernel calls). Meanwhile it stands in for the
    thread's call, as its own ``record``: spans open and close on it
    untimed."""

    def __init__(self):
        self.counters = collections.Counter()
        self.launches = collections.Counter()
        self.pending = collections.defaultdict(list)
        self.syncs = collections.Counter()
        self.stack = []
        self.root = _Span("icpflow.recording")
        self.record = self

    def open(self, s: _Span):
        pass

    def close(self, s: _Span):
        pass


@contextlib.contextmanager
def recording():
    """For the capture of a CUDA graph: inside the block the thread's
    call, traced or not, is set aside; spans are not timed and what is
    counted goes into the yielded :class:`Recorded`, so that every replay
    can add it to the call that replays it (:func:`recount`)."""
    saved = _local.call
    rec = _local.call = Recorded()
    try:
        yield rec
    finally:
        _local.call = saved


def launch(kernel: str, shape: tuple, n: int = 1):
    """Counts ``n`` calls of ``kernel`` at ``shape`` in the ledger and, in
    a traced call, as its counter ``launches.<kernel>``; under
    :func:`recording`, in the recording only."""
    call = _local.call
    if type(call) is Recorded:
        call.launches[kernel, shape] += n
        return
    _launches[kernel, shape] += n
    if call is not None:
        call.record.counters["launches." + kernel] += n


def launch_counts(prefix: str = "") -> collections.Counter:
    """Kernel name -> calls in the ledger, of the names that start with
    ``prefix``."""
    out = collections.Counter()
    for (k, _), n in _launches.items():
        if k.startswith(prefix):
            out[k] += n
    return out


def launch_total(prefix: str = "") -> int:
    """Kernel calls in the ledger whose kernel name starts with ``prefix``."""
    return sum(launch_counts(prefix).values())


def launch_shapes(prefix: str = "") -> collections.Counter:
    """(kernel name, shape) -> calls in the ledger, of the names that start
    with ``prefix``."""
    return collections.Counter({key: n for key, n in _launches.items()
                                if key[0].startswith(prefix)})


def clear_launches():
    """Empties the ledger of kernel calls."""
    _launches.clear()


def recount(rec: Recorded):
    """Adds what a recorded capture counted, as one more run of it: its
    kernel calls to the ledger (:func:`launch`) and, in a traced call, the
    numbers, and a copy of each tensor, taken now (after the replay that
    wrote it)."""
    for (kernel, shape), n in rec.launches.items():
        launch(kernel, shape, n)
    if _local.call is None:
        return
    for name, n in rec.counters.items():
        count(name, n)
    for name, ts in rec.pending.items():
        for t in ts:
            count(name, t.clone())


def calls() -> list:
    """The last :data:`RING` traced calls of the process, oldest first."""
    return list(_ring)


def clear():
    """Forgets every kept call."""
    _ring.clear()


class StageClock:
    """Per-stage milliseconds into ``out``: CUDA events on a CUDA device
    (read after one synchronize at the end), host clock on the CPU.

    ``mark(name)`` starts stage ``name`` and ends the one before;
    ``mark("end")`` ends the last; ``finish()`` writes the stages into
    ``out``. With ``out`` None the clock does nothing.

    With ``out`` given, the call is traced: the outermost clock of the
    thread opens the call's trace (root span ``icpflow.<entry>``) and an
    inner clock joins it; each stage is also a span ``icpflow.<stage>``.
    The outermost clock ends the trace when it leaves its ``with`` block,
    or at ``finish()`` where it is not used as a context manager.
    """

    def __init__(self, out: Optional[dict], device: torch.device,
                 entry: str = "call"):
        self.out = out
        self.cuda = device.type == "cuda"
        self.marks = []
        self.owned = None          # the trace this clock opened
        self.stage = None          # the open stage span
        self.scoped = False
        if out is not None and _local.call is None:
            self.owned = _local.call = _Call(entry, device)

    def __enter__(self):
        self.scoped = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.owned is not None:
            self.owned.end(keep=exc_type is None)
            self.owned = None
        return False

    def mark(self, name: str):
        if self.out is None:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))
        call = _local.call
        if call is None:
            return
        if self.stage is not None:
            call.close(self.stage)
            self.stage = None
        if name != "end":
            self.stage = _Span("icpflow." + name)
            call.open(self.stage)

    def finish(self):
        if self.out is None:
            return
        if self.marks:
            if self.cuda:
                torch.cuda.synchronize()
            for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
                self.out[name] = (a.elapsed_time(b) if self.cuda
                                  else (b - a) * 1e3)
        call = _local.call
        if self.stage is not None and call is not None:
            call.close(self.stage)
            self.stage = None
        if self.owned is not None and not self.scoped:
            self.owned.end(keep=True)
            self.owned = None
