# Frozen copy of the port's plain path, icpflow_tpu_torch/ops/cluster.py, for the
# benchmark's reference. It imports nothing of the program; leave it as
# it is when the program changes: it is the yardstick.
"""Voxel-hash DBSCAN with min-label propagation and its voxel-dedup form
(hdbscan's graphs, which the benchmark's configurations do not run, are
left out of this copy).

Port of ``dbscan``, ``dbscan_dedup`` and ``voxel_dedup_compact`` from
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
   Each run's first within-radius candidate is an edge.
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
    """Step 2-3 for the first ``nv`` sorted positions. Returns counts (nv,)
    int64 and edges (nv, 9) (sorted positions, ``n`` where none)."""
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
    if not counts:
        return (torch.zeros((0,), dtype=torch.int64, device=dev),
                torch.zeros((0, 9), dtype=torch.int64, device=dev))
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
    number of ``rounds``.
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
    cnt_v, edg_v = _candidates(xyz_s, eps_s, ids_s, mult_s, span, nv, n,
                               rcap, eps, eps_scale_per_m)
    counts = torch.zeros((n,), dtype=torch.int64, device=dev)
    counts[:nv] = cnt_v
    edges = torch.full((n, 9), n, dtype=torch.int64, device=dev)
    edges[:nv] = edg_v
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
