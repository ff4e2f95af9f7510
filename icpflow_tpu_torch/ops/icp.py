"""Batched masked point-to-point ICP with init-pose rollback.

Port of ``icpflow_tpu/ops/icp.py``. Each pair carries a convergence latch
(patience on the best inlier rmse), returns its best visited pose, and may
run a wide-gate coarse phase first. The reference's ``lax.while_loop`` and
its tail compaction become one loop in which every trip runs only the rows
that are not yet frozen: rows are independent, and a frozen row's pose and
best pose never change, so this is the same computation.

Rows freeze only at the latch, so the active rows stay the same for runs
of trips, the segments. A segment's inputs and state are gathered once,
in row order, into a compacted working set (:class:`_Work`), on which
:func:`_trip` runs every trip of the segment at the shape (rows, N, M)
that gathering the rows every trip gives, so every kernel sees the same
values at the same shape. When rows freeze, their best poses go back to
the output and the next segment gathers the rows left. The exit test is
one host read a trip: the working set's ``frozen``.

On a CPU tensor :func:`_trip` runs as it is. On a CUDA tensor each trip is
one replay of a CUDA graph of :func:`_trip`, captured the first time its
key (:func:`graph_key`: the shape, the device, the phase and the constants
the graph bakes in) is seen, over working-set buffers shared by the keys
of one shape; the graphs share one memory pool and the least recently used
is dropped past :data:`GRAPH_CACHE`. A replay adds the kernel calls the
capture made to the trace's ledger, and what it counted to the traced call
(``trace.recording``, ``trace.recount``). Inside :func:`eager_trips` the
trips run as on the CPU. The cache and its working sets belong to the
process: one call at a time uses them.

A traced call counts the trips (``icp_iters``) and makes each a span
``icpflow.icp.iter`` (a replay's Kabsch has no span of its own); on a CUDA
device it counts the captures (``icp_graph_captures``) and the replays
(``icp_graph_replays``). The exit test's read falls in the enclosing span.
"""

from __future__ import annotations

import collections
import contextlib
import weakref

import torch

from .. import trace as _trace
from . import geometry as geo
from . import knn as _knn

# Captured trips kept, the least recently used dropped first. An entry is a
# graph of ~70 kernels and, shared with the other keys of its shape, one
# working set: the largest measured 4.0 MB (PERF.md §3), so 192 entries
# hold at most 0.77 GB of working sets; the intermediates of every graph
# share one pool (36 MiB after 100 distinct frame pairs).
GRAPH_CACHE = 192

COARSE, FIRST, LATER = "coarse", "first", "later"      # phases of a trip
INPUTS = ("src", "src_mask", "dst", "dst_mask")
STATE = ("R_cur", "t_cur", "best_R", "best_t", "best_rmse", "stale",
         "frozen")


class _Work:
    """The compacted working set of a segment: the inputs of its rows
    (:data:`INPUTS`) and their state (:data:`STATE`), k rows each,
    contiguous."""
    __slots__ = INPUTS + STATE + ("__weakref__",)

    def __init__(self, k, n, m, src_mask_dtype, dst_mask_dtype, dev):
        f32 = torch.float32
        self.src = torch.empty((k, n, 3), dtype=f32, device=dev)
        self.src_mask = torch.empty((k, n), dtype=src_mask_dtype, device=dev)
        self.dst = torch.empty((k, m, 3), dtype=f32, device=dev)
        self.dst_mask = torch.empty((k, m), dtype=dst_mask_dtype, device=dev)
        self.R_cur = torch.empty((k, 3, 3), dtype=f32, device=dev)
        self.t_cur = torch.empty((k, 3), dtype=f32, device=dev)
        self.best_R = torch.empty((k, 3, 3), dtype=f32, device=dev)
        self.best_t = torch.empty((k, 3), dtype=f32, device=dev)
        self.best_rmse = torch.empty((k,), dtype=f32, device=dev)
        self.stale = torch.empty((k,), dtype=torch.int32, device=dev)
        self.frozen = torch.empty((k,), dtype=torch.bool, device=dev)

    def nbytes(self) -> int:
        return sum(getattr(self, a).nbytes for a in INPUTS + STATE)


def _trip(w: _Work, phase: str, thr: float, patience: int,
          stall_rel: float, tile: int) -> None:
    """One ICP trip over the working set, its state updated in place:
    the active rows' sweep, Kabsch, rmse and (past the coarse phase) the
    latch and best pose, gated at ``thr``."""
    f32 = torch.float32
    s, sm = w.src, w.src_mask
    moved = torch.einsum("bij,bnj->bni", w.R_cur, s) + w.t_cur[:, None, :]
    # only rows under ``sm`` are read below (``inlier``): the sweep skips
    # the others, which changes no bit of the result
    nn_pts, dist = _knn.masked_nn_points(moved, w.dst, w.dst_mask,
                                         tile=tile, src_mask=sm)
    inlier = (dist <= thr) & sm
    R, t = geo.kabsch(s, nn_pts, inlier)
    moved2 = torch.einsum("bij,bnj->bni", R, s) + t[:, None, :]
    sq = torch.sum((moved2 - nn_pts) ** 2, dim=-1)
    wt = inlier.to(f32)
    rmse = torch.sqrt(torch.sum(sq * wt, 1)
                      / torch.clamp(torch.sum(wt, 1), min=1e-9))

    if phase == COARSE:
        st = torch.zeros_like(w.stale)
    else:
        prev = w.best_rmse
        if phase == FIRST:
            take = meaningful = torch.ones_like(rmse, dtype=torch.bool)
        else:
            take = rmse < prev
            meaningful = (prev - rmse) > stall_rel * torch.clamp(prev,
                                                                 min=1e-20)
        st = torch.where(meaningful, torch.zeros_like(w.stale), w.stale + 1)
        tk = take[:, None]
        w.best_R.copy_(torch.where(tk[:, :, None], R, w.best_R))
        w.best_t.copy_(torch.where(tk, t, w.best_t))
        w.best_rmse.copy_(torch.where(take, rmse, prev))
    w.stale.copy_(st)
    w.frozen.copy_(st >= patience)
    w.R_cur.copy_(R)
    w.t_cur.copy_(t)


def graph_key(work: _Work, phase: str, thres: float, coarse_thr: float,
              patience: int, stall_rel: float) -> tuple:
    """The key of a captured trip: (rows, N, M, device, phase, the NN
    sweep's form, the masks' dtypes, thres, the coarse gate, patience,
    stall_rel): everything the graph bakes in. The NN launch plan follows
    from the shape and the form."""
    k, n, _ = work.src.shape
    m = work.dst.shape[1]
    return (k, n, m, str(work.src.device), phase, _knn.sweep_form(m, False),
            work.src_mask.dtype, work.dst_mask.dtype, float(thres),
            float(coarse_thr), int(patience), float(stall_rel))


class _Graph:
    """One captured trip over ``work``: the graph, and what its capture
    launched and counted, which every replay adds again."""
    __slots__ = ("graph", "work", "counted")


_graphs: collections.OrderedDict = collections.OrderedDict()
_works: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_streams: dict = {}
_eager = False           # inside eager_trips()


@contextlib.contextmanager
def eager_trips():
    """Inside the block :func:`icp_core` runs every trip eagerly on a CUDA
    tensor too, as on the CPU: no graph is captured or replayed. For tests
    and measuring scripts (the launch table's pass that keeps each NN
    launch's live inputs); the result is the same, bit for bit."""
    global _eager
    saved, _eager = _eager, True
    try:
        yield
    finally:
        _eager = saved


def graph_cache() -> dict:
    """The captured trips, least recently used first: key -> the graph's
    working set (tests and measuring scripts read it)."""
    return {k: g.work for k, g in _graphs.items()}


def graph_cache_bytes() -> int:
    """Bytes of the working sets the captured trips hold (the shared pool's
    intermediates not included)."""
    works = {id(g.work): g.work for g in _graphs.values()}
    return sum(w.nbytes() for w in works.values())


def clear_graphs() -> None:
    """Drops every captured trip and working set."""
    _graphs.clear()
    _works.clear()


def _work_for(k, n, m, src_mask, dst_mask, dev) -> _Work:
    """The working set of shape (k, n, m): on a CUDA device the one its
    captured trips read (shared by every key of the shape), else new."""
    if dev.type != "cuda":
        return _Work(k, n, m, src_mask.dtype, dst_mask.dtype, dev)
    wkey = (k, n, m, src_mask.dtype, dst_mask.dtype, str(dev))
    work = _works.get(wkey)
    if work is None:
        work = _works[wkey] = _Work(k, n, m, src_mask.dtype,
                                    dst_mask.dtype, dev)
    return work


def _capture(work: _Work, phase: str, thr: float, patience: int,
             stall_rel: float, tile: int) -> _Graph:
    """Capture :func:`_trip` over ``work`` on a side stream into the
    device's shared pool. The ledger and the trace keep nothing of the
    capture: its kernel calls and counts are kept in the entry."""
    dev = work.src.device
    if dev not in _streams:
        _streams[dev] = torch.cuda.Stream(dev)
    stream = _streams[dev]
    # the pool of a live graph of the device, or a new one (a pool no graph
    # holds any more is gone)
    live = next((e for e in _graphs.values() if e.work.src.device == dev),
                None)
    pool = None if live is None else live.graph.pool()
    g = _Graph()
    g.graph = torch.cuda.CUDAGraph()
    g.work = work
    stream.wait_stream(torch.cuda.current_stream(dev))
    with _trace.recording() as rec, torch.cuda.stream(stream):
        g.graph.capture_begin(pool=pool)
        try:
            _trip(work, phase, thr, patience, stall_rel, tile)
        except BaseException:
            try:
                g.graph.capture_end()
            except RuntimeError:
                pass            # the capture's own error: the trip's
            raise
        g.graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    g.counted = rec
    return g


def _replay(work: _Work, phase: str, thres: float, coarse_thr: float,
            patience: int, stall_rel: float, tile: int) -> None:
    """One trip on the card: the key's graph replayed, captured first
    where the key is new; its launches and counts added as if it ran."""
    key = graph_key(work, phase, thres, coarse_thr, patience, stall_rel)
    g = _graphs.get(key)
    if g is None:
        g = _capture(work, phase, coarse_thr if phase == COARSE else thres,
                     patience, stall_rel, tile)
        _graphs[key] = g
        while len(_graphs) > GRAPH_CACHE:
            _graphs.popitem(last=False)
        _trace.count("icp_graph_captures")
    else:
        _graphs.move_to_end(key)
    g.graph.replay()
    _trace.count("icp_graph_replays")
    _trace.recount(g.counted)


def icp_core(src: torch.Tensor, src_mask: torch.Tensor, dst: torch.Tensor,
             dst_mask: torch.Tensor, coarse_on: bool = True, *,
             thres: float = 0.1, max_iters: int = 100, tile: int = 1024,
             patience: int = 5, stall_rel: float = 1e-4, corr_cap: int = 0,
             coarse_iters: int = 0, coarse_scale: float = 3.0) -> torch.Tensor:
    """Rigid ICP aligning ``src`` onto ``dst``. Returns (B,4,4).

    ``corr_cap`` > 0 strides the source side of the correspondence search
    down to at most that many points. ``coarse_iters`` > 0 (with
    ``coarse_on``) gates the first that many sweeps at
    ``thres * coarse_scale``; the latch and best-pose bookkeeping count only
    the fine iterations.
    """
    b = src.shape[0]
    dev = src.device
    f32 = torch.float32
    src = src.to(f32)
    dst = dst.to(f32)
    if corr_cap and src.shape[1] > corr_cap:
        stride = -(-src.shape[1] // corr_cap)
        src = src[:, ::stride]
        src_mask = src_mask[:, ::stride]
    n, m = src.shape[1], dst.shape[1]

    eff = coarse_iters if (coarse_iters and coarse_on) else 0
    coarse_thr = thres * coarse_scale
    graphs = dev.type == "cuda" and not _eager
    best_R = torch.eye(3, dtype=f32, device=dev).expand(b, 3, 3).clone()
    best_t = torch.zeros((b, 3), dtype=f32, device=dev)
    k = b                                   # rows of the segment
    rows = torch.arange(b, device=dev)      # their indices, in order
    work = None
    for it in range(max_iters):
        if k == 0:
            break
        phase = COARSE if it < eff else FIRST if it == eff else LATER
        with _trace.span("icpflow.icp.iter"):
            _trace.count("icp_iters")
            if work is None:
                work = _work_for(k, n, m, src_mask, dst_mask, dev)
                for name, full in zip(INPUTS, (src, src_mask, dst, dst_mask)):
                    torch.index_select(full, 0, rows, out=getattr(work, name))
                if it == 0:
                    work.R_cur.copy_(best_R)
                    work.t_cur.zero_()
                    work.best_R.copy_(best_R)
                    work.best_t.zero_()
                    work.best_rmse.fill_(float("inf"))
                    work.stale.zero_()
                    work.frozen.zero_()
                else:
                    for name in STATE:
                        torch.index_select(getattr(last, name), 0, keep,
                                           out=getattr(work, name))
            if graphs:
                _replay(work, phase, thres, coarse_thr, patience, stall_rel,
                        tile)
            else:
                _trip(work, phase, coarse_thr if phase == COARSE else thres,
                      patience, stall_rel, tile)
        frozen = work.frozen.tolist()
        left = frozen.count(False)
        if left < k:                        # the segment ends
            best_R.index_copy_(0, rows, work.best_R)
            best_t.index_copy_(0, rows, work.best_t)
            if left:                        # the rows left, in order
                keep = torch.argsort(work.frozen.to(torch.uint8),
                                     stable=True)[:left]
                rows = rows[keep]
            last, work, k = work, None, left
    if work is not None:
        best_R.index_copy_(0, rows, work.best_R)
        best_t.index_copy_(0, rows, work.best_t)
    return geo.rt_to_mat(best_R, best_t)


def apply_icp(src: torch.Tensor, src_mask: torch.Tensor, dst: torch.Tensor,
              dst_mask: torch.Tensor, init_poses: torch.Tensor,
              coarse_on: bool = True, *, thres: float = 0.1,
              max_iters: int = 100, tile: int = 1024, patience: int = 5,
              stall_rel: float = 1e-4, corr_cap: int = 0,
              coarse_iters: int = 0, coarse_scale: float = 3.0,
              init_margin: float = 0.0,
              init_margin_rel: float = 0.0) -> torch.Tensor:
    """ICP from an init pose, rolled back to the init unless it beats the
    init's masked NN error by max(init_margin, init_margin_rel * err_init)
    (ICP-Flow `utils_icp.py:20-48`, margin extension of the reference)."""
    src_init = geo.transform_points_batch(src, init_poses)
    rts = icp_core(src_init, src_mask, dst, dst_mask, coarse_on,
                   thres=thres, max_iters=max_iters, tile=tile,
                   patience=patience, stall_rel=stall_rel,
                   corr_cap=corr_cap, coarse_iters=coarse_iters,
                   coarse_scale=coarse_scale)
    rts = geo.compose(rts, init_poses)
    err_init = _knn.masked_nn_error(src_init, src_mask, dst, dst_mask,
                                    tile=tile)
    moved = geo.transform_points_batch(src, rts)
    err_icp = _knn.masked_nn_error(moved, src_mask, dst, dst_mask, tile=tile)
    margin = torch.clamp(init_margin_rel * err_init, min=init_margin)
    invalid = err_icp >= err_init - margin
    return torch.where(invalid[:, None, None], init_poses, rts)
