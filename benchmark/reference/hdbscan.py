"""HDBSCAN for the benchmark's reference: the port's exact kNN graph, frozen,
and the condensed tree written from its published description, in plain
PyTorch and numpy. It imports nothing of the program and no native library.

ICP-Flow's ``--if_hdbscan`` clusters the non-ground points of both frames
jointly with the ``hdbscan`` package (``utils_cluster.py:10-29``:
``min_cluster_size``, ``min_samples=None``), after Campello, Moulavi and
Sander, "Density-Based Clustering Based on Hierarchical Density Estimates"
(PAKDD 2013), as McInnes, Healy and Astels describe the library (JOSS 2017):
core distances, the mutual-reachability graph, its minimum spanning tree,
the single-linkage dendrogram, the condensed tree under
``min_cluster_size``, excess-of-mass selection, labels. This module follows
the port's choices where they depart from the package:

* the graph: the exact k-nearest-neighbour mutual-reachability graph (k =
  ``min(min_cluster_size, 30)``, 20 at the configurations' value), not a
  kd-tree Boruvka over the complete graph. The two give the same spanning
  tree only where every edge of the complete graph's tree joins a point to
  one of its k nearest neighbours, and a connected kNN graph does not
  ensure that: elsewhere the kNN graph's tree joins the two sides by a
  heavier edge, or not at all. Each component of a kNN graph that is not
  connected is a root of the dendrogram, eligible for selection, and an
  undersized lone component stays noise;
* weighted masses: on the ``dedup`` path a node is one representative of
  a 0.15 m voxel, standing for its points (its multiplicity), and sizes,
  the ``min_cluster_size`` gate and stability count points;
* the border reclaim (``hdbscan_reclaim``, 0.5 m): noise adopts the label
  of its lightest labelled edge within that weight, twice; the package has
  no such step. Then the clusters are ranked by size and the largest
  ``num_clusters`` kept, as ``utils_cluster.py:26-27`` does;
* the tie order: edges enter the tree in the order (weight, source row,
  destination), so the tree is a function of the edge set alone.

The graph and the finishing step are frozen copies of the port's
(``ops/cluster.py: exact_knn_mutual_reachability``, ``ops/hdbscan.py:
_finish_labels``); the tree is not a copy of the port's C++ but its own
code: the spanning forest by Boruvka rounds over the edges' ranks in that
order (exact, since a total order makes the forest unique), then Kruskal's
dendrogram over the forest's edges in rank order, the condensed tree and
the selection in Python.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cluster import _pad1, voxel_dedup_compact
from .engine import Reference

_BIG = 1e9                        # "no distance": excluded pairs, no edge
_GRAPH_BLOCK = 1 << 26            # d2 elements of one block (256 MB fp32)
_NO_EDGE = np.float32(1e8)        # a weight at or above it is no edge
_LAM_INF = np.float32(1e9)        # lambda of a merge at distance 0


# ------------------------------------------------ the graph (frozen copy)
def _sq_dist_expanded(p: torch.Tensor, q: torch.Tensor,
                      psq: torch.Tensor, qsq: torch.Tensor) -> torch.Tensor:
    """(S, M) squared distances in the expanded form
    ``(|p|^2 - 2 p.q) + |q|^2``: three separately rounded fp32 multiplies
    summed left to right, so a pair's d2 does not depend on its block."""
    d2 = p[:, None, 0] * q[None, :, 0]
    d2 += p[:, None, 1] * q[None, :, 1]
    d2 += p[:, None, 2] * q[None, :, 2]
    d2 *= -2.0
    d2 += psq[:, None]
    d2 += qsq[None, :]
    return d2


def _smallest_k(d2: torch.Tensor, k: int, stats: dict):
    """The k smallest entries of each row, by value and then the lowest
    column. ``torch.topk`` picks among equal values arbitrarily, so it takes
    k + 1 and sorts them by (value, column); rows whose k-th and (k+1)-th
    values are equal (below ``_BIG``) are sorted again whole, stably."""
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


def exact_knn_mutual_reachability(xyz: torch.Tensor, valid: torch.Tensor,
                                  mult: Optional[torch.Tensor] = None, *,
                                  k: int = 20, block: int = _GRAPH_BLOCK,
                                  info: Optional[dict] = None):
    """Exact kNN mutual-reachability graph, brute force over the valid
    points: each one's k nearest valid others by expanded d2, ties to the
    lowest index, missing neighbours (1e9, N). The core distance is the
    k-th neighbour's, or with ``mult`` the distance at which the cumulative
    multiplicity (the point's own ``mult - 1`` duplicates included) first
    reaches k. Weights ``max(d, core_p, core_q)``. Returns core (N,),
    edge_dst (N, k) int32 (N = no edge), edge_w (N, k) f32 (1e9 = no
    edge); ``info`` receives ``rows``, ``blocks`` and ``tie_rows``."""
    n = xyz.shape[0]
    dev = xyz.device
    xyz = xyz.to(torch.float32)
    valid = valid.to(torch.bool)
    vidx = torch.nonzero(valid)[:, 0]
    m = vidx.numel()
    d2_knn = torch.full((n, k), _BIG, dtype=torch.float32, device=dev)
    idx_knn = torch.full((n, k), n, dtype=torch.int64, device=dev)
    stats = dict(rows=m, blocks=0, tie_rows=0)
    if m:
        q = xyz[vidx]
        qsq = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
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
            d2_knn[vidx[r0:r1], :kk] = torch.where(
                none, torch.full_like(vals, _BIG), vals)
            idx_knn[vidx[r0:r1], :kk] = torch.where(
                none, torch.full_like(cols, n), vidx[cols])
            stats["blocks"] += 1
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


# ------------------------------------------------------------- the tree
def _ordered_edges(edge_dst: torch.Tensor, edge_w: torch.Tensor):
    """The graph's edges (a, b, w), a the row, in the order (w, a, b);
    slots with an index outside [0, N) or a weight of 1e8 or more are no
    edges. -0.0 reads as 0.0, as an ordered comparison takes it."""
    n, k = edge_dst.shape
    dev = edge_dst.device
    b = edge_dst.reshape(-1).to(torch.int64)
    w = edge_w.reshape(-1).to(torch.float32) + 0.0
    a = torch.arange(n, device=dev).repeat_interleave(k)
    keep = (b >= 0) & (b < n) & (w < float(_NO_EDGE))
    a, b, w = a[keep], b[keep], w[keep]
    order = torch.sort(a * n + b).indices
    order = order[torch.sort(w[order], stable=True).indices]
    return a[order], b[order], w[order]


def _components(n: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(n,) the smallest node of each node's component under the edges
    (u, v): min-label propagation with pointer jumping."""
    lab = torch.arange(n, device=u.device)
    while True:
        m = torch.minimum(lab[u], lab[v])
        new = lab.clone()
        new.scatter_reduce_(0, u, m, reduce="amin")
        new.scatter_reduce_(0, v, m, reduce="amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab
        lab = new


def spanning_forest(n: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ranks (positions in the given order) of the minimum spanning
    forest's edges, ascending. The ranks are distinct, so the forest is
    unique and Kruskal's; Boruvka rounds find it: each component takes its
    lightest outgoing edge, until no edge leaves a component."""
    dev = a.device
    e = a.numel()
    rank = torch.arange(e, device=dev)
    comp = torch.arange(n, device=dev)
    chosen = []
    while True:
        ca, cb = comp[a], comp[b]
        out = ca != cb
        a, b, rank, ca, cb = a[out], b[out], rank[out], ca[out], cb[out]
        if not rank.numel():
            break
        best = torch.full((n,), e, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, ca, rank, reduce="amin")
        best.scatter_reduce_(0, cb, rank, reduce="amin")
        pick = torch.unique(best[best < e])
        chosen.append(pick)
        # the picked edges are ranks; map them back to this round's rows
        at = torch.searchsorted(rank, pick)
        merged = _components(n, ca[at], cb[at])
        comp = merged[comp]
    if not chosen:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    return torch.sort(torch.cat(chosen)).values


def condensed_labels(a: np.ndarray, b: np.ndarray, w: np.ndarray, n: int,
                     min_cluster_size: int,
                     node_w: Optional[np.ndarray] = None) -> np.ndarray:
    """Labels (n,) int32 (-1 noise) from the spanning forest's edges (a, b,
    w) in ascending order: Kruskal's single-linkage dendrogram, the
    condensed tree under ``min_cluster_size`` with point masses
    (``node_w``, 1 each by default), excess-of-mass selection.

    Every root of the dendrogram forest is an eligible cluster born at
    lambda 0; a cluster without children is selected when its members
    reach ``min_cluster_size``. lambda = 1 / distance in float32 (1e9 at
    distance 0), stability sums in float64, in the order of the walk."""
    mass = [1] * n if node_w is None else [int(x) for x in node_w]
    # Kruskal over the forest's edges: each unites two components
    parent = list(range(n))
    comp_node = list(range(n))
    left, right, size = [], [], []

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def node_size(v):
        return mass[v] if v < n else size[v - n]

    for ea, eb in zip(a.tolist(), b.tolist()):
        ra, rb = find(ea), find(eb)
        na, nb = comp_node[ra], comp_node[rb]
        left.append(na)
        right.append(nb)
        size.append(node_size(na) + node_size(nb))
        parent[ra] = rb
        comp_node[rb] = n + len(left) - 1
    n_merge = len(left)
    dist = np.asarray(w, np.float32)
    lam_all = np.full(n_merge, _LAM_INF, np.float32)
    np.divide(np.float32(1.0), dist, out=lam_all, where=dist > 0)
    lam_all = lam_all.tolist()          # float32 values, held exactly

    is_child = bytearray(n + n_merge)
    for x in left:
        is_child[x] = 1
    for x in right:
        is_child[x] = 1

    f32 = np.float32
    c_parent, c_birth, c_stab, c_size = [], [], [], []
    point_cluster = [-1] * n

    def new_cluster(par, birth):
        c_parent.append(par)
        c_birth.append(birth)
        c_stab.append(0.0)
        c_size.append(0)
        return len(c_parent) - 1

    def assign_subtree(node, cluster, lam):
        st = [node]
        birth = c_birth[cluster]
        gap = float(f32(lam) - f32(birth))
        while st:
            v = st.pop()
            if v < n:
                point_cluster[v] = cluster
                c_stab[cluster] += float(mass[v]) * gap
                c_size[cluster] += mass[v]
            else:
                st.append(left[v - n])
                st.append(right[v - n])

    stack = []
    for v in range(n, n + n_merge):
        if not is_child[v]:
            stack.append((v, new_cluster(-1, 0.0)))
    while stack:
        v, cluster = stack.pop()
        i = v - n
        lam = lam_all[i]
        lv, rv = left[i], right[i]
        sl, sr = node_size(lv), node_size(rv)
        bl, br = sl >= min_cluster_size, sr >= min_cluster_size
        if bl and br:
            c_stab[cluster] += float(sl + sr) * float(
                f32(lam) - f32(c_birth[cluster]))
            cl = new_cluster(cluster, lam)
            cr = new_cluster(cluster, lam)
            for child, c in ((lv, cl), (rv, cr)):
                if child >= n:
                    stack.append((child, c))
                else:
                    point_cluster[child] = c
                    c_size[c] += mass[child]
        else:
            for child, big in ((lv, bl), (rv, br)):
                if big and child >= n:
                    stack.append((child, cluster))
                else:
                    assign_subtree(child, cluster, lam)

    # excess of mass, children before parents (a child's id is larger)
    nc = len(c_parent)
    children = [[] for _ in range(nc)]
    for c in range(nc):
        if c_parent[c] >= 0:
            children[c_parent[c]].append(c)
    subtree = [0.0] * nc
    own = [False] * nc
    for c in range(nc - 1, -1, -1):
        child_sum = 0.0
        for ch in children[c]:
            child_sum += subtree[ch]
        if not children[c]:
            subtree[c] = c_stab[c]
            own[c] = c_size[c] >= min_cluster_size
        elif c_stab[c] > child_sum:
            subtree[c] = c_stab[c]
            own[c] = True
        else:
            subtree[c] = child_sum
    # a cluster stays selected unless an ancestor was selected after it;
    # a point takes the label of the first selected cluster up its path
    label_of = [-1] * nc
    above = [False] * nc
    n_sel = 0
    for c in range(nc):
        p = c_parent[c]
        if p >= 0:
            above[c] = above[p] or own[p]
        if own[c] and not above[c]:
            label_of[c] = n_sel
            n_sel += 1
        elif p >= 0:
            label_of[c] = label_of[p]
    lab = np.asarray(label_of + [-1], np.int32)
    return lab[np.asarray(point_cluster, np.int64)]


def tree_labels(edge_dst: torch.Tensor, edge_w: torch.Tensor,
                min_cluster_size: int,
                node_w: Optional[np.ndarray] = None) -> np.ndarray:
    """Labels (N,) int32 of the graph ``edge_dst``, ``edge_w`` (N, k): the
    edges in the order (w, a, b), their spanning forest, the tree."""
    n = edge_dst.shape[0]
    a, b, w = _ordered_edges(edge_dst, edge_w)
    keep = spanning_forest(n, a, b)
    return condensed_labels(a[keep].cpu().numpy(), b[keep].cpu().numpy(),
                            w[keep].cpu().numpy(), n, min_cluster_size,
                            node_w)


# ------------------------------------------- the finish (frozen copy)
def _finish_labels(labels: np.ndarray, valid_h: np.ndarray,
                   edge_dst: np.ndarray, edge_w: np.ndarray, cfg,
                   sizes_w: Optional[np.ndarray] = None) -> np.ndarray:
    """Border reclaim, then the size-ranked top-``num_clusters`` dense
    relabel (``sizes_w``: a representative counts its multiplicity)."""
    labels = labels.copy()
    labels[~valid_h] = -1

    if cfg.hdbscan_reclaim > 0:
        ed = np.asarray(edge_dst)
        ew = np.asarray(edge_w)
        in_range = ed < len(labels)
        ed_c = np.minimum(ed, len(labels) - 1)
        for _ in range(2):
            nbr_lab = np.where(in_range, labels[ed_c], -1)
            cand = (nbr_lab >= 0) & (ew <= cfg.hdbscan_reclaim) & in_range
            w_masked = np.where(cand, ew, np.inf)
            best = np.argmin(w_masked, axis=1)
            has = np.isfinite(w_masked[np.arange(len(labels)), best])
            adopt = (labels < 0) & valid_h & has
            labels = np.where(
                adopt, nbr_lab[np.arange(len(labels)), best], labels)
    pos = labels >= 0
    if not pos.any():
        return labels.astype(np.int32)
    w = sizes_w if sizes_w is not None else np.ones(len(labels), np.int64)
    counts = np.bincount(labels[pos], weights=w[pos])
    labs = np.flatnonzero(counts)
    order = labs[np.argsort(-counts[labs])][: cfg.num_clusters]
    remap = np.full(labels.max() + 1, -1, np.int32)
    remap[order] = np.arange(len(order), dtype=np.int32)
    out = np.where(pos, remap[np.maximum(labels, 0)], -1)
    return out.astype(np.int32)


# ----------------------------------------------------------- the clusterer
def hdbscan(xyz: torch.Tensor, valid: torch.Tensor, cfg,
            info: Optional[dict] = None) -> np.ndarray:
    """Labels (N,) int32 on the host, clusters 0..C-1 by size, -1 noise.
    The path is the port's: one representative a ``hdbscan_dedup_voxel``
    voxel with its multiplicity (``dedup``), or every valid point where
    more voxels are occupied than ``hdbscan_rep_cap`` (``full``);
    ``info`` receives ``path`` and ``n_unique``."""
    if not cfg.hdbscan_exact or cfg.hdbscan_fetch_f16:
        raise ValueError("the reference has only the exact graph, fetched "
                         "in float32")
    k = min(cfg.min_cluster_size, 30)
    xyz = xyz.to(torch.float32)
    valid = valid.to(torch.bool)
    n_unique = None
    if cfg.hdbscan_dedup_voxel > 0:
        rep_xyz, rep_valid, rep_mult, point_rep, n_unique = (
            voxel_dedup_compact(xyz, valid, voxel=cfg.hdbscan_dedup_voxel,
                                cap=cfg.hdbscan_rep_cap))
        if n_unique <= cfg.hdbscan_rep_cap:
            _, ed, ew = exact_knn_mutual_reachability(rep_xyz, rep_valid,
                                                      rep_mult, k=k)
            mult_h = rep_mult.to(torch.int32).cpu().numpy()
            rep_labels = tree_labels(ed, ew, cfg.min_cluster_size, mult_h)
            rep_labels = _finish_labels(
                rep_labels, rep_valid.cpu().numpy(), ed.cpu().numpy(),
                ew.cpu().numpy(), cfg, sizes_w=mult_h.astype(np.int64))
            lab_pad = np.concatenate(
                [rep_labels, np.full((1,), -1, np.int32)])
            out = lab_pad[np.minimum(point_rep.to(torch.int32).cpu().numpy(),
                                     cfg.hdbscan_rep_cap)]
            out[~valid.cpu().numpy()] = -1
            if info is not None:
                info.update(path="dedup", n_unique=n_unique)
            return out.astype(np.int32)
    _, ed, ew = exact_knn_mutual_reachability(xyz, valid, k=k)
    labels = tree_labels(ed, ew, cfg.min_cluster_size)
    out = _finish_labels(labels, valid.cpu().numpy(), ed.cpu().numpy(),
                         ew.cpu().numpy(), cfg)
    if info is not None:
        info.update(path="full", n_unique=n_unique)
    return out


class HdbscanReference(Reference):
    """The reference with ``use_hdbscan`` routed to :func:`hdbscan`."""

    def labels(self, pts, valid):
        if not self.cfg.use_hdbscan:
            return super().labels(pts, valid)
        return torch.as_tensor(hdbscan(pts, valid, self.cfg)).to(pts.device)
