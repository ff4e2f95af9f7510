"""Voxel-hash DBSCAN with min-label propagation, its voxel-dedup form, and
hdbscan's mutual-reachability graphs.

Port of ``dbscan``, ``dbscan_dedup``, ``voxel_dedup_compact``,
``exact_knn_mutual_reachability`` and ``mutual_reachability_edges`` from
``icpflow_tpu/ops/cluster.py``. The semantics are the reference's, down to
the candidate set, the propagation branch and the iteration cap, because
labels depend on all three; the layout is not (the reference gathers from
an overlapped row table because row gathers are slow on its chip).
Every binning multiplies by the fp32 reciprocal of the cell size, as XLA
compiles the reference's division by a constant (``_cells``).

DBSCAN, step by step:

1. Points are binned into cells of side ``eps`` (``eps_max`` in adaptive
   mode), ids z-minor, and stably sorted by cell.
2. Candidates of the point at sorted position i: for each of the 9 (dx, dy)
   columns, the run of its 3 z-adjacent cells, which is one contiguous range
   [st, st + tt) of sorted positions. The candidates are the positions
   [st, st + min(tt, rcap)) inside [0, n_valid).
3. Neighbour count: per run, the multiplicity-weighted number of candidates
   within the mutual radius min(eps_i, eps_j), scaled by tt / min(tt, rcap);
   summed over runs and rounded half to even. Core iff count >= min_points.
   Each run's first within-radius candidate is an edge. On the card steps
   2-3 are one launch of a hand-written kernel (``csrc/dbscan.cu``).
4. Connected components of core points by min-label propagation over one of
   three graphs, chosen by the reference's condition: cell-contracted edges
   (cliques of cells of side eps/sqrt(3)), the compacted point edges, or the
   full (N, 9) edge slab. At most ``max_iters`` rounds.
5. Border points adopt the smallest adjacent core label; the rest is noise.
6. Clusters ranked by (weighted) size, the top ``num_clusters`` kept and
   relabelled 0..C-1; ties go to the lowest root index.
"""

from __future__ import annotations

import math

import torch

from .. import trace as _trace
from .cuda import dbscan as _cuda_dbscan
from .cuda import knn_graph as _cuda_knn
from .geometry import scale_as_xla

_NBR9 = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
_NBR9.sort(key=lambda o: (o != (0, 0), o))       # center run first

_NONE = 2 ** 30                                  # invalid cell id
_CAND_ELEMS = 1 << 23                            # candidates per chunk


def _cells(xyz: torch.Tensor, valid: torch.Tensor, size: float, pad: int):
    """Integer cells of side ``size``, offset so valid cells start at
    ``pad``, and the per-axis span (with ``pad`` cells of margin each
    side). Binned as the reference's jitted ``floor(xyz / size)`` is
    compiled, by a multiply with the fp32 reciprocal (``scale_as_xla``), so
    that a point on a cell boundary falls into the same cell."""
    cell = torch.floor(scale_as_xla(xyz, size)).to(torch.int64)
    v = valid[:, None]
    cmin = torch.where(v, cell, torch.full_like(cell, 2 ** 20)).amin(0)
    cmax = torch.where(v, cell, torch.full_like(cell, -(2 ** 20))).amax(0)
    span = torch.clamp(cmax - cmin + 1 + 2 * pad, min=1)
    return cell - cmin + pad, span


def _flat_id(cc: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    return (cc[:, 0] * span[1] + cc[:, 1]) * span[2] + cc[:, 2]


def _scatter_min(target: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    return target.scatter_reduce_(0, index, src, reduce="amin")


def _pad1(x: torch.Tensor, value: int) -> torch.Tensor:
    return torch.cat([x, x.new_full((1,), value)])


def _candidates(xyz_s, eps_s, ids_s, mult_s, span, nv, n, rcap, eps,
                eps_scale_per_m):
    """Steps 2-3 for the sorted positions: counts (n,) int64 and edges
    (n, 9) int64 (sorted positions, ``n`` where none; rows from ``nv`` on
    0 and ``n``). On a CUDA tensor one launch of the hand-written kernel
    (``ops/cuda/dbscan.py``, ``dbscan_candidates`` in the trace's ledger
    of kernel calls), on a CPU tensor :func:`_candidates_plain`; the two
    agree bit for bit on the card."""
    if xyz_s.is_cuda:
        return _cuda_dbscan.dbscan_candidates_cuda(
            xyz_s, eps_s, ids_s, mult_s, span, nv, rcap, eps,
            eps_scale_per_m > 0.0)
    return _candidates_plain(xyz_s, eps_s, ids_s, mult_s, span, nv, n, rcap,
                             eps, eps_scale_per_m)


def _candidates_plain(xyz_s, eps_s, ids_s, mult_s, span, nv, n, rcap, eps,
                      eps_scale_per_m):
    """Plain PyTorch version of :func:`_candidates` (``csrc/dbscan.cu``):
    the first ``nv`` rows in chunks of ``_CAND_ELEMS`` candidates
    (``dbscan_candidates_plain`` in the ledger)."""
    _trace.launch("dbscan_candidates_plain", (nv, rcap))
    dev = xyz_s.device
    deltas = torch.stack([(dx * span[1] + dy) * span[2] - 1
                          for dx, dy in _NBR9])                  # (9,)
    lo = ids_s[:nv, None] + deltas[None, :]
    st = torch.searchsorted(ids_s, lo)
    tt = torch.searchsorted(ids_s, lo + 3) - st
    k = torch.arange(rcap, device=dev)
    totf = tt.to(torch.float32)
    scale = totf / torch.clamp(torch.clamp(totf, max=float(rcap)), min=1.0)
    adaptive = eps_scale_per_m > 0.0
    r_fixed = torch.tensor(eps, dtype=torch.float32, device=dev)

    counts, edges = [], []
    step = max(1, _CAND_ELEMS // (9 * rcap))
    for r0 in range(0, nv, step):
        r1 = min(nv, r0 + step)
        s = st[r0:r1, :, None]
        pos = s + k                                              # (c,9,R)
        ok = (k < tt[r0:r1, :, None]) & (pos < nv)
        pos_c = torch.clamp(pos, max=n - 1)
        g = xyz_s[pos_c]                                         # (c,9,R,3)
        d = g - xyz_s[r0:r1, None, None, :]
        d_sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        # mutual adaptive radius: edge iff d <= min(eps_i, eps_j)
        if adaptive:
            r = torch.minimum(eps_s[r0:r1, None, None], eps_s[pos_c])
        else:
            r = r_fixed
        within = ok & (d_sq <= r * r)
        if mult_s is None:
            hits = within.sum(2).to(torch.float32)
        else:
            hits = torch.where(within, mult_s[pos_c], 0).sum(2).to(
                torch.float32)
        hs = hits * scale[r0:r1]
        acc = hs[:, 0]
        for j in range(1, 9):                    # run order, left to right
            acc = acc + hs[:, j]
        counts.append(torch.round(acc).to(torch.int64))
        first = torch.where(within, pos, torch.full_like(pos, _NONE)).amin(2)
        edges.append(torch.where(first < _NONE, first,
                                 torch.full_like(first, n)))
    counts.append(torch.zeros((n - nv,), dtype=torch.int64, device=dev))
    edges.append(torch.full((n - nv, 9), n, dtype=torch.int64, device=dev))
    return torch.cat(counts), torch.cat(edges)


def _propagate(body, label, max_iters):
    """Rounds of ``body`` until a round changes nothing, at most
    ``max_iters`` rounds. Returns (label, rounds)."""
    rounds = 0
    for rounds in range(1, max_iters + 1):
        new = body(label)
        changed = bool(torch.any(new != label))
        label = new
        if not changed:
            break
    return label, rounds


def dbscan(xyz: torch.Tensor, valid: torch.Tensor,
           mult: torch.Tensor | None = None, *, eps: float = 0.25,
           min_points: int = 30, num_clusters: int = 200,
           cell_cap: int = 64, max_iters: int = 200,
           eps_scale_per_m: float = 0.0, eps_max: float = 1.0,
           range_cap: int | None = None,
           info: dict | None = None) -> torch.Tensor:
    """Labels (N,) int32: 0..C-1 size-ranked clusters, -1 noise/dropped.

    ``range_cap``: candidate cap per 3-z-cell run (default ``2 * cell_cap``).
    ``mult``: optional (N,) point multiplicities (voxel representatives):
    counts and sizes weight each point by it. ``info``, when given, receives
    the propagation ``path`` ("contracted", "compact" or "slab") and its
    number of ``rounds``, which a traced call also counts
    (``dbscan_rounds``).
    """
    n = xyz.shape[0]
    dev = xyz.device
    xyz = xyz.to(torch.float32)
    valid = valid.to(torch.bool)
    adaptive = eps_scale_per_m > 0.0
    cell_size = eps_max if adaptive else eps
    rcap = min(2 * cell_cap if range_cap is None else range_cap, n)
    if adaptive:
        rng_xy = torch.sqrt(xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1])
        eps_pt = torch.clamp(eps + eps_scale_per_m * rng_xy, eps, eps_max)
    else:
        eps_pt = torch.full((n,), eps, dtype=torch.float32, device=dev)

    # --- 1. cells, stable sort (invalid ids sort to the back) -------------
    cc, span = _cells(xyz, valid, cell_size, pad=1)
    ids = torch.where(valid, _flat_id(cc, span),
                      torch.full((n,), _NONE, dtype=torch.int64, device=dev))
    order = torch.sort(ids, stable=True).indices
    ids_s = ids[order]
    xyz_s = xyz[order]
    eps_s = eps_pt[order]
    valid_s = valid[order]
    nv = int(valid.sum())
    mult_s = None
    if mult is not None:
        mult_s = torch.where(valid_s, mult.to(torch.int64)[order], 0)

    # --- 2-3. candidates, counts, first-hit edges -------------------------
    counts, edges = _candidates(xyz_s, eps_s, ids_s, mult_s, span, nv, n,
                                rcap, eps, eps_scale_per_m)
    core = (counts >= min_points) & valid_s

    # --- 4. min-label propagation over core points ------------------------
    idx = torch.arange(n, device=dev)
    core_pad = _pad1(core, False)
    flat_v = edges.reshape(-1)
    ecap = min(4 * n, flat_v.shape[0])
    sel = torch.nonzero(flat_v < n)[:, 0]
    can_compact = sel.numel() <= ecap
    e_u = sel // 9
    e_v = flat_v[sel]

    def jumps_twice(new):
        for _ in range(2):
            new_pad = _pad1(new, n)
            new = torch.where(core, torch.minimum(new, new_pad[new_pad[new]]),
                              n)
        return new

    def border_adopt(label):
        lab_pad = _pad1(label, n)
        from_u = torch.where(core_pad[e_u], lab_pad[e_u], n)
        from_v = torch.where(core_pad[e_v], lab_pad[e_v], n)
        border = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
        _scatter_min(border, e_u, from_v)
        _scatter_min(border, e_v, from_u)
        return border[:n]

    path = "slab"
    if can_compact:
        path = "compact"
        # fine-cell contraction: cells of side eps/sqrt(3) are cliques
        fcc, fspan = _cells(xyz_s, valid_s, eps / math.sqrt(3.0), pad=0)
        nf = int(fspan[0] * fspan[1] * fspan[2])
        if nf <= (1 << 22):
            fid = torch.clamp(_flat_id(fcc, fspan), 0, nf - 1)
            table = torch.full((nf,), n, dtype=torch.int64, device=dev)
            _scatter_min(table, fid[core], idx[core])
            rep = torch.where(core, table[fid], n)
            rep_of = _pad1(rep, n)
            cc_all = core_pad[e_u] & core_pad[e_v]
            ru = torch.where(cc_all, rep_of[e_u], n)
            rv = torch.where(cc_all, rep_of[e_v], n)
            ca = torch.minimum(ru, rv)
            cb = torch.maximum(ru, rv)
            alive = (ca != cb) & (ca < n)
            keys = torch.unique(ca[alive] * (n + 1) + cb[alive])
            ccap = min(max(n // 2, 49152), ecap)
            rl_cap = max(1024, n // 4)
            is_rep = core & (rep == idx)
            if keys.numel() <= ccap and int(is_rep.sum()) <= rl_cap:
                path = "contracted"
                cu = keys // (n + 1)
                cv = keys % (n + 1)
                rlist = torch.nonzero(is_rep)[:, 0]

    if path == "contracted":
        def body(lab):
            lab_pad = _pad1(lab, n)
            m = torch.minimum(lab_pad[cu], lab_pad[cv])
            new = lab_pad.clone()
            _scatter_min(new, cu, m)
            _scatter_min(new, cv, m)
            # pointer jump over the rep list, two levels of rep->rep chain
            lr = new[rlist]
            jumped = torch.minimum(lr, new[new[lr]])
            _scatter_min(new, rlist, jumped)
            return new[:n]

        label, rounds = _propagate(body, torch.where(core, rep, n), max_iters)
        # a final gather through ``rep`` resolves non-rep members
        label = torch.where(core, torch.minimum(label, _pad1(label, n)[rep]),
                            n)
        border_lab = border_adopt(label)
    elif path == "compact":
        cc_edge = core_pad[e_u] & core_pad[e_v]
        p_u = torch.where(cc_edge, e_u, n)
        p_v = torch.where(cc_edge, e_v, n)

        def body(lab):
            lab_pad = _pad1(lab, n)
            m = torch.minimum(lab_pad[p_u], lab_pad[p_v])
            _scatter_min(lab_pad, p_u, m)
            _scatter_min(lab_pad, p_v, m)
            return jumps_twice(torch.where(core, lab_pad[:n], n))

        label, rounds = _propagate(body, torch.where(core, idx, n), max_iters)
        border_lab = border_adopt(label)
    else:
        core_edges = torch.where(core_pad[edges] & core[:, None], edges, n)
        flat_ce = core_edges.reshape(-1)

        def body(lab):
            lab_pad = _pad1(lab, n)
            pulled = lab_pad[core_edges].amin(1)
            pushed = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
            _scatter_min(pushed, flat_ce, lab[:, None].expand(n, 9).reshape(-1))
            new = torch.minimum(lab, torch.minimum(pulled, pushed[:n]))
            return jumps_twice(torch.where(core, new, n))

        label, rounds = _propagate(body, torch.where(core, idx, n), max_iters)
        lab_pad = _pad1(label, n)
        border_lab = torch.where(core_pad[edges], lab_pad[edges], n).amin(1)

    _trace.count("dbscan_rounds", rounds)
    if info is not None:
        info.update(path=path, rounds=rounds)

    # --- 5. border points adopt an adjacent core label --------------------
    label = torch.where(core, label,
                        torch.where(valid_s & (border_lab < n), border_lab, n))

    # --- 6. size-ranked top-K relabelling ---------------------------------
    lab_c = torch.clamp(label, max=n)
    if mult_s is None:
        sizes = torch.bincount(lab_c, minlength=n + 1)[:n]
    else:
        sizes = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
        sizes.index_add_(0, lab_c, mult_s)
        sizes = sizes[:n]
    c = min(num_clusters, n)
    top_roots = torch.sort(sizes, descending=True, stable=True).indices[:c]
    keep = sizes[top_roots] > 0
    rank = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    rank[top_roots[keep]] = torch.arange(c, device=dev)[keep]
    final_s = torch.where(label < n, rank[lab_c], -1)

    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out[order] = final_s
    return torch.where(valid, out, -1).to(torch.int32)


def voxel_dedup_compact(xyz: torch.Tensor, valid: torch.Tensor, *,
                        voxel: float, cap: int):
    """One representative (the first point in sorted order) per occupied
    voxel, in a ``cap`` bucket, with its point count as multiplicity.

    Returns (rep_xyz (cap,3), rep_valid (cap,), rep_mult (cap,) int64,
    point_rep (N,) int64 with ``cap`` for invalid or overflowed points,
    n_unique int). Callers must check ``n_unique <= cap``.
    """
    n = xyz.shape[0]
    dev = xyz.device
    xyz = xyz.to(torch.float32)
    valid = valid.to(torch.bool)
    cc, span = _cells(xyz, valid, voxel, pad=0)
    ids = torch.where(valid, _flat_id(cc, span),
                      torch.full((n,), _NONE, dtype=torch.int64, device=dev))
    order = torch.sort(ids, stable=True).indices
    ids_s = ids[order]
    xyz_s = xyz[order]
    live = ids_s < _NONE
    first = live.clone()
    first[1:] &= ids_s[1:] != ids_s[:-1]
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    rank = torch.where(live, torch.clamp(rank, max=cap), cap)
    n_unique = int(first.sum())

    keep = first & (rank < cap)
    rep_xyz = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    rep_xyz[rank[keep]] = xyz_s[keep]
    rep_mult = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    rep_mult.index_add_(0, rank, torch.ones_like(rank))
    rep_valid = torch.arange(cap, device=dev) < min(n_unique, cap)
    point_rep = torch.full((n,), cap, dtype=torch.int64, device=dev)
    point_rep[order] = rank
    return rep_xyz, rep_valid, rep_mult[:cap], point_rep, n_unique


def dbscan_dedup(xyz: torch.Tensor, valid: torch.Tensor, *,
                 dedup_voxel: float, rep_cap: int, **dbscan_kw) -> torch.Tensor:
    """DBSCAN on voxel-dedup representatives, labels broadcast per point.

    The weighted ``dbscan`` counts raw points, so core/border decisions and
    size ranking keep raw-cloud semantics. A scene with more occupied voxels
    than ``rep_cap`` clusters the full cloud instead (never truncated).
    Needs ``dedup_voxel * sqrt(3) < eps``.
    """
    eps_floor = dbscan_kw.get("eps", 0.25)
    if dedup_voxel * 1.7320509 >= eps_floor:
        raise ValueError(
            f"cluster_dedup_voxel={dedup_voxel} too coarse for eps="
            f"{eps_floor}: points in one voxel must be mutually within eps "
            f"(voxel * sqrt(3) < eps)")
    rep_xyz, rep_valid, rep_mult, point_rep, n_unique = voxel_dedup_compact(
        xyz, valid, voxel=dedup_voxel, cap=rep_cap)
    if n_unique > rep_cap:
        return dbscan(xyz, valid, **dbscan_kw)
    lab_r = dbscan(rep_xyz, rep_valid, rep_mult, **dbscan_kw)
    return _pad1(lab_r, -1)[point_rep]


# --------------------------------------------------------------------------
# hdbscan's device half: k-core distances and mutual-reachability edges
# --------------------------------------------------------------------------
_OFFSETS = [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_OFFSETS.sort(key=lambda o: (o != (0, 0, 0), o))     # center cell first

_BIG = 1e9                        # "no distance": excluded pairs, no edge
_GRAPH_BLOCK = 1 << 26            # d2 elements of one block (256 MB fp32)


def _sq_dist_expanded(p: torch.Tensor, q: torch.Tensor,
                      psq: torch.Tensor, qsq: torch.Tensor) -> torch.Tensor:
    """(S, M) squared distances in the reference's expanded form
    ``(|p|^2 - 2 p.q) + |q|^2``. The K = 3 product is three separately
    rounded fp32 multiplies summed left to right, so a pair's d2 does not
    depend on the block it is computed in."""
    d2 = p[:, None, 0] * q[None, :, 0]
    d2 += p[:, None, 1] * q[None, :, 1]
    d2 += p[:, None, 2] * q[None, :, 2]
    d2 *= -2.0
    d2 += psq[:, None]
    d2 += qsq[None, :]
    return d2


def _smallest_k(d2: torch.Tensor, k: int, stats: dict):
    """The k smallest entries of each row in ``lax.top_k`` order: by value,
    the lowest column first among equal values. Returns (values, columns),
    (S, min(k, M)).

    ``torch.topk`` picks among equal values arbitrarily, so it takes k + 1
    and the k + 1 are sorted by (value, column). That is exact wherever the
    k-th and (k+1)-th values differ: then no entry left out equals one kept.
    Rows where they are equal (below ``_BIG``: equal ``_BIG`` entries become
    "no edge" anyway) are sorted again whole, stably."""
    m = d2.shape[1]
    kk = min(k + 1, m)
    vals, cols = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    cols, perm = torch.sort(cols, dim=1)
    vals, perm2 = torch.sort(torch.gather(vals, 1, perm), dim=1, stable=True)
    cols = torch.gather(cols, 1, perm2)
    if kk > k:
        tie = torch.nonzero((vals[:, k - 1] == vals[:, k])
                            & (vals[:, k - 1] < _BIG))[:, 0]
        if tie.numel():
            full = torch.sort(d2[tie], dim=1, stable=True)
            vals[tie] = full.values[:, :kk]
            cols[tie] = full.indices[:, :kk]
        stats["tie_rows"] += int(tie.numel())
    return vals[:, :k], cols[:, :k]


def graph_points(xyz: torch.Tensor, valid: torch.Tensor):
    """The rows of the exact graph: the valid points' indices ``vidx``,
    the points q (m, 3) and their squared norms ``(x*x + y*y) + z*z``."""
    vidx = torch.nonzero(valid)[:, 0]
    q = xyz[vidx]
    return vidx, q, (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]


def _knn_graph(q: torch.Tensor, qsq: torch.Tensor, k: int, block: int,
               stats: dict):
    """Each of the m rows of ``q`` (m, 3), ``qsq`` its squared norms: its k
    nearest other rows by the expanded d2 in ``lax.top_k`` order. Returns
    vals (m, k) f32 and cols (m, k) int64, compacted columns, (1e9, m)
    where none; adds the tie rows to ``stats``. On a CUDA tensor one launch
    of the hand-written kernel (``ops/cuda/knn_graph.py``, ``knn_graph`` in
    the trace's ledger of kernel calls), whose tie count is read on the
    host; on a CPU tensor :func:`_knn_graph_plain`, which adds its blocks
    too. The two agree bit for bit on the card."""
    if q.is_cuda:
        vals, cols, ties = _cuda_knn.knn_graph_cuda(
            torch.cat([q, qsq[:, None]], 1), k)
        stats["tie_rows"] += int(ties)
        return vals, cols.to(torch.int64)
    return _knn_graph_plain(q, qsq, k, block, stats)


def _knn_graph_plain(q: torch.Tensor, qsq: torch.Tensor, k: int, block: int,
                     stats: dict):
    """Plain PyTorch version of :func:`_knn_graph` (``csrc/knn_graph.cu``):
    blocks of rows of at most ``block`` d2 entries, each d2 block by
    :func:`_sq_dist_expanded`, self at ``_BIG``, then :func:`_smallest_k`
    (``knn_graph_plain`` in the ledger, once a call)."""
    m = q.shape[0]
    _trace.launch("knn_graph_plain", (m, k))
    dev = q.device
    vals_m = torch.full((m, k), _BIG, dtype=torch.float32, device=dev)
    cols_m = torch.full((m, k), m, dtype=torch.int64, device=dev)
    step = max(1, block // m)
    for r0 in range(0, m, step):
        r1 = min(m, r0 + step)
        d2 = _sq_dist_expanded(q[r0:r1], q, qsq[r0:r1], qsq)
        rows = torch.arange(r1 - r0, device=dev)
        d2[rows, rows + r0] = _BIG                        # self
        vals, cols = _smallest_k(d2, k, stats)
        del d2
        kk = vals.shape[1]
        none = vals >= _BIG
        vals_m[r0:r1, :kk] = torch.where(none, torch.full_like(vals, _BIG),
                                         vals)
        cols_m[r0:r1, :kk] = torch.where(none, torch.full_like(cols, m),
                                         cols)
        stats["blocks"] += 1
    return vals_m, cols_m


def exact_knn_mutual_reachability(xyz: torch.Tensor, valid: torch.Tensor,
                                  mult: torch.Tensor | None = None, *,
                                  k: int = 20, knn_recall: float = 0.0,
                                  block: int = _GRAPH_BLOCK,
                                  info: dict | None = None):
    """Exact k-nearest-neighbour mutual-reachability graph, brute force.

    Port of the reference's ``exact_knn_mutual_reachability``. For every
    valid point: its k nearest valid other points by squared distance in
    the expanded form ``|p|^2 - 2 p.q + |q|^2`` (fp32, the reference's
    HIGHEST-precision product; see ``_sq_dist_expanded``), ordered by d2
    and, among equal d2, by the lowest index (the reference's ``lax.top_k``
    merge); missing neighbours are (1e9, N). The core distance is the k-th
    neighbour's distance or, with ``mult`` (voxel representatives' point
    counts), the distance at which the cumulative multiplicity, the point's
    own ``mult - 1`` duplicates included, first reaches k. Edge weights are
    ``max(d, core_p, core_q)``.

    Returns core (N,) f32 (1e9 for invalid points), edge_dst (N, k) int32
    (N = no edge) and edge_w (N, k) f32 (1e9 = no edge).

    Only valid rows and columns are computed (``_knn_graph``): on a CUDA
    tensor by the hand-written kernel, on a CPU tensor in blocks of at most
    ``block`` d2 entries (a block of valid src rows against every valid
    dst); the result does not depend on the block size or the device.
    ``knn_recall`` is accepted for the reference's signature and changes
    nothing: its ``approx_min_k`` is exact on the CPU, and this function is
    exact. ``info``, when given, receives ``rows``, ``blocks`` (the plain
    version's blocks; 0 on the card, whose launch the trace's ledger
    counts) and ``tie_rows`` (the rows whose k-th and (k+1)-th d2 were
    equal; the plain version sorts them whole). The function returns
    behind its device work: it reads the blocks' or the kernel's tie count
    on the host.

    Numerics: the expanded d2 carries ~ulp(|x|^2) of rounding noise,
    ~6e-5 m^2 at 30 m from the origin against a neighbour's 0.02-0.09 m^2.
    XLA's dot rounds the K = 3 product otherwise than these three
    multiplies, so neighbours with d2 that close can swap places against
    the reference; parity tests keep their scenes within a few metres of
    the origin. The
    port runs the same operations on the card and the CPU: on a lidar pair's
    representatives they agree on every index and within 6e-8 m.
    """
    del knn_recall
    n = xyz.shape[0]
    dev = xyz.device
    xyz = xyz.to(torch.float32)
    valid = valid.to(torch.bool)
    vidx, q, qsq = graph_points(xyz, valid)
    m = vidx.numel()
    d2_knn = torch.full((n, k), _BIG, dtype=torch.float32, device=dev)
    idx_knn = torch.full((n, k), n, dtype=torch.int64, device=dev)
    stats = dict(rows=m, blocks=0, tie_rows=0)
    if m:
        vals, cols = _knn_graph(q, qsq, k, block, stats)
        d2_knn[vidx] = vals
        idx_knn[vidx] = _pad1(vidx, n)[cols]
    if info is not None:
        info.update(stats)
    d_knn = torch.sqrt(torch.clamp(d2_knn, min=0.0))

    if mult is None:
        core = torch.where(valid, d_knn[:, k - 1], _BIG)
    else:
        mult = mult.to(torch.int64)
        mpad = _pad1(mult, 0)
        nb_mult = torch.where(d_knn < 1e8, mpad[torch.clamp(idx_knn, max=n)],
                              0)
        cum = (mult - 1)[:, None] + torch.cumsum(nb_mult, dim=1)
        reached = cum >= k
        first = torch.argmax(reached.to(torch.int8), dim=1)
        core_w = torch.gather(d_knn, 1, first[:, None])[:, 0]
        core_w = torch.where((mult - 1) >= k, 0.0, core_w)
        core = torch.where(valid & reached.any(1), core_w, _BIG)
    core_pad = _pad1(core, _BIG)
    w = torch.maximum(d_knn, torch.maximum(
        core[:, None], core_pad[torch.clamp(idx_knn, max=n)]))
    w = torch.where((d_knn < 1e8) & valid[:, None], w, _BIG)
    edge_dst = torch.where(w < 1e8, idx_knn, n).to(torch.int32)
    return core, edge_dst, w


def _mre_candidates(xyz_s, cc_s, ids_s, valid_s, span, offs, r0, r1, n,
                    cell_cap):
    """Candidates of sorted rows [r0, r1): up to ``cell_cap`` points of each
    of the 27 cells around the row's (searchsorted from the cell's first
    point), center cell first. Returns (sorted positions (c, 27 * cap),
    distances (c, 27 * cap), 1e9 where not usable)."""
    dev = xyz_s.device
    c = r1 - r0
    qid = _flat_id((cc_s[r0:r1, None, :] + offs[None]).reshape(-1, 3),
                   span).reshape(c, len(_OFFSETS))
    start = torch.searchsorted(ids_s, qid)
    pos = start[:, :, None] + torch.arange(cell_cap, device=dev)
    pos_c = torch.clamp(pos, max=n - 1)
    same = (ids_s[pos_c] == qid[:, :, None]) & (pos < n)
    pos_c = pos_c.reshape(c, -1)
    same = same.reshape(c, -1)
    dd = xyz_s[pos_c] - xyz_s[r0:r1, None, :]
    d = torch.sqrt((dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1])
                   + dd[..., 2] * dd[..., 2])
    rows = torch.arange(r0, r1, device=dev)
    usable = same & valid_s[pos_c] & (pos_c != rows[:, None])
    return pos_c, torch.where(usable, d, _BIG)


def _mre_level(xyz, valid, *, k_core: int, edges_per_point: int,
               cell_size: float, cell_cap: int, core_full=None,
               counts: list | None = None):
    """One resolution level of the voxel-hash mutual-reachability graph.

    Without ``core_full``: each point's distance to its k-th candidate
    (1e9 if it has fewer), in original order: an upper bound on the true
    k-th neighbour distance. With ``core_full`` (the final core vector):
    each point's ``edges_per_point`` lightest edges, weight
    ``max(d, core_p, core_q)``, ordered by weight and, among equal weights,
    by candidate order (the reference's stable argsort); returns (edge_dst
    (N, E) int64 with N = no edge, edge_w (N, E) f32). ``counts``, when
    given, receives each chunk's number of usable candidates (a device
    scalar)."""
    n = xyz.shape[0]
    dev = xyz.device
    cc, span = _cells(xyz, valid, cell_size, pad=1)
    ids = torch.where(valid, _flat_id(cc, span),
                      torch.full((n,), _NONE, dtype=torch.int64, device=dev))
    order = torch.sort(ids, stable=True).indices
    ids_s = ids[order]
    xyz_s = xyz[order]
    cc_s = cc[order]
    valid_s = valid[order]
    nv = int(valid.sum())
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)
    step = max(1, _CAND_ELEMS // (len(_OFFSETS) * cell_cap))
    core_s = None if core_full is None else core_full[order]

    outs = []
    for r0 in range(0, nv, step):
        r1 = min(nv, r0 + step)
        pos, d = _mre_candidates(xyz_s, cc_s, ids_s, valid_s, span, offs,
                                 r0, r1, n, cell_cap)
        if counts is not None:
            counts.append((d < _BIG).sum())
        if core_s is None:
            kth = torch.topk(d, k_core, dim=1, largest=False).values[:, -1]
            outs.append(torch.clamp(kth, max=_BIG))
            continue
        w = torch.maximum(d, torch.maximum(core_s[r0:r1, None], core_s[pos]))
        w = torch.where(d < 1e8, w, _BIG)
        # stable argsort of the non-negative weights: one int64 key of
        # (weight bits, candidate column), unique per row
        col = torch.arange(w.shape[1], device=dev)
        key = (w.view(torch.int32).to(torch.int64) << 32) | col
        sel = torch.topk(key, edges_per_point, dim=1, largest=False).values
        sel = sel & 0xFFFFFFFF
        ew = torch.gather(w, 1, sel)
        ep = torch.where(ew < 1e8, torch.gather(pos, 1, sel), n)
        outs.append((ep, ew))

    if core_s is None:
        core = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
        if outs:
            core[order[:nv]] = torch.cat(outs)
        return core
    orig_of_sorted = _pad1(order, n)
    edge_dst = torch.full((n, edges_per_point), n, dtype=torch.int64,
                          device=dev)
    edge_w = torch.full((n, edges_per_point), _BIG, dtype=torch.float32,
                        device=dev)
    if outs:
        edge_dst[order[:nv]] = orig_of_sorted[torch.cat([o[0] for o in outs])]
        edge_w[order[:nv]] = torch.cat([o[1] for o in outs])
    return edge_dst, edge_w


def mutual_reachability_edges(xyz: torch.Tensor, valid: torch.Tensor, *,
                              k_core: int = 15, edges_per_point: int = 8,
                              cell_sizes: tuple = (0.35, 1.0, 3.0),
                              cell_cap: int = 64, info: dict | None = None):
    """The voxel-hash mutual-reachability graph over several cell sizes.

    Port of the reference's ``mutual_reachability_edges`` (its
    ``hdbscan_exact=False`` graph). At each level candidates are up to
    ``cell_cap`` points of each of the 27 cells around a point. The core
    distance is the least over levels of the k-th candidate distance (each
    level's is an upper bound on the true one); each level then adds its
    ``edges_per_point`` lightest edges under the final core vector.

    Returns core (N,) f32, edge_dst (N, L * E) int32 (N = no edge),
    edge_w (N, L * E) f32. The graph is translation-variant: a shift moves
    points across cell boundaries. ``info``, when given, receives
    ``candidates``: the usable (point, candidate) pairs of all passes.
    """
    xyz = xyz.to(torch.float32)
    valid = valid.to(torch.bool)
    counts = None if info is None else []
    kw = dict(k_core=k_core, edges_per_point=edges_per_point,
              cell_cap=cell_cap, counts=counts)
    core = None
    for c in cell_sizes:
        lvl = _mre_level(xyz, valid, cell_size=c, **kw)
        core = lvl if core is None else torch.minimum(core, lvl)
    eds, ews = zip(*[_mre_level(xyz, valid, cell_size=c, core_full=core, **kw)
                     for c in cell_sizes])
    if info is not None:
        info["candidates"] = int(sum(counts)) if counts else 0
    return core, torch.cat(eds, 1).to(torch.int32), torch.cat(ews, 1)
