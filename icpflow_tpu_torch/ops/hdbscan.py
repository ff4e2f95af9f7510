"""HDBSCAN: the graph on the device, the tree on the host.

Port of ``icpflow_tpu/ops/hdbscan.py``, the reference's primary clusterer
(hdbscan with ``min_cluster_size`` and ``min_samples=None``):

* device (``ops/cluster.py``): k-core distances and the lightest
  mutual-reachability edges. The default path first collapses the cloud to
  one representative per fine voxel (``voxel_dedup_compact``,
  ``hdbscan_dedup_voxel``) with integer multiplicities, so that core
  distances and condensed-tree masses still count points, and builds the
  exact kNN graph over the representatives;
* host, native C++ (``native/npz_reader.cc``: ``ifh_hdbscan_labels`` and
  ``ifh_hdbscan_labels_weighted``, through ``data/native_loader.get_lib``):
  Kruskal MST, condensed tree, excess-of-mass selection, labels;
* host, numpy (``_finish_labels``): border reclaim and the size-ranked
  dense relabel, verbatim from the reference so that its ties fall the same
  way.

A scene with more occupied voxels than ``hdbscan_rep_cap`` takes the full
exact graph instead (counted in ``DEDUP_OVERFLOWS``, never truncated);
``hdbscan_exact=False`` takes the voxel-hash graph. Without the native
library the reference falls back to range-adaptive DBSCAN, and so does
this port (``info["path"] == "dbscan_fallback"``).

Numerics: the exact graph's expanded-form d2 rounds differently on each
device and library (see ``exact_knn_mutual_reachability``), and near-equal
edge weights can then enter the spanning tree in another order, which moves
a few fringe points between clusters. End-to-end parity holds within the
flow band, not bit for bit, away from the origin.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.native_loader import get_lib
from ..device import StageClock
from . import cluster as _cluster

# how often a scene overflowed hdbscan_rep_cap and took the full exact graph
DEDUP_OVERFLOWS = 0


def _native_labels(edge_dst: np.ndarray, edge_w: np.ndarray,
                   min_cluster_size: int,
                   node_w: Optional[np.ndarray] = None
                   ) -> Optional[np.ndarray]:
    """Condensed-tree labels from the native library (weighted by
    ``node_w`` when given); None when the library or the symbol is
    missing."""
    lib = get_lib()
    if lib is None:
        return None
    n, e = edge_dst.shape
    ed = np.ascontiguousarray(edge_dst, np.int32)
    ew = np.ascontiguousarray(edge_w, np.float32)
    out = np.empty((n,), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    if node_w is not None:
        if not hasattr(lib, "ifh_hdbscan_labels_weighted"):
            return None
        fn = lib.ifh_hdbscan_labels_weighted
        fn.restype = ctypes.c_int64
        fn.argtypes = [i32p, f32p, i32p, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_int32, i32p]
        nw = np.ascontiguousarray(node_w, np.int32)
        fn(ed.ctypes.data_as(i32p), ew.ctypes.data_as(f32p),
           nw.ctypes.data_as(i32p), n, e, min_cluster_size,
           out.ctypes.data_as(i32p))
        return out
    if not hasattr(lib, "ifh_hdbscan_labels"):
        return None
    fn = lib.ifh_hdbscan_labels
    fn.restype = ctypes.c_int64
    fn.argtypes = [i32p, f32p, ctypes.c_int64, ctypes.c_int32,
                   ctypes.c_int32, i32p]
    fn(ed.ctypes.data_as(i32p), ew.ctypes.data_as(f32p), n, e,
       min_cluster_size, out.ctypes.data_as(i32p))
    return out


def _finish_labels(labels: np.ndarray, valid_h: np.ndarray,
                   edge_dst: np.ndarray, edge_w: np.ndarray,
                   cfg: PipelineConfig,
                   sizes_w: Optional[np.ndarray] = None) -> np.ndarray:
    """Shared tail: border reclaim + size-ranked top-K dense relabel.

    ``sizes_w``: optional per-node weights for the size ranking (dedup path:
    a representative counts its multiplicity, `utils_cluster.py:26-27`
    ranks by point count).
    """
    labels = labels.copy()
    labels[~valid_h] = -1

    if cfg.hdbscan_reclaim > 0:
        # border reclaim: EOM selection sheds low-density cluster fringes;
        # re-attach noise points whose lightest mutual-reachability edge to a
        # labelled point is within the reclaim distance (two passes to chain)
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
    # keep top num_clusters by size, relabel densely (utils_cluster.py:26-27)
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


def compress_edges(edge_dst: torch.Tensor, edge_w: torch.Tensor):
    """The ``hdbscan_fetch_f16`` form of an edge list: indices clipped to
    65535 as 16 bits (returned as int16 holding the uint16 bit pattern),
    weights clipped at 6e4 and rounded to f16, to nearest even as XLA's
    convert does. ``expand_edges`` restores the "no edge" sentinel from the
    index, so the clip loses nothing for real edges."""
    ed = torch.clamp(edge_dst.to(torch.int32), max=65535)
    ed = torch.where(ed >= 32768, ed - 65536, ed).to(torch.int16)
    ew = torch.clamp(edge_w, max=6.0e4).to(torch.float16)
    return ed, ew


def expand_edges(ed: np.ndarray, ew: np.ndarray, n_rep: int):
    """Host side of ``compress_edges``: int32 indices, f32 weights, and
    weight 1e9 wherever the index says "no edge" (>= ``n_rep``)."""
    ed = ed.view(np.uint16).astype(np.int32)
    ew = ew.astype(np.float32)
    ew[ed >= n_rep] = 1e9
    return ed, ew


def _fetch(*tensors: torch.Tensor):
    """Every tensor to the host as numpy with one synchronize: each is
    copied asynchronously into pinned host memory, then the stream is
    waited on once. For hdbscan's 4.1 MB this is faster than one ``.cpu()``
    a tensor or one copy of their bytes packed on the device (``python3
    chip_smoke.py``, ``[hdbscan fetch]``)."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


def hdbscan(xyz: torch.Tensor, valid: torch.Tensor, cfg: PipelineConfig,
            info: Optional[dict] = None, timed: bool = False) -> np.ndarray:
    """Labels (N,) int32 on the host: clusters 0..C-1 ranked by size, -1
    noise.

    k (min_samples) follows the reference's ``min_samples=None``: equal to
    ``min_cluster_size``, capped at 30. ``info``, when given, receives the
    ``path`` taken ("dedup", "full", "voxel_hash" or "dbscan_fallback"),
    ``n_unique`` (occupied voxels, None without dedup), the exact graph's
    ``graph`` counters (the ``info`` of ``exact_knn_mutual_reachability``,
    host values it reads anyway) and ``ms``, empty unless ``timed``. With
    ``timed`` (and ``info``), ``ms`` holds the milliseconds of each stage
    by CUDA events on a CUDA device (``dedup``, ``graph``, ``fetch``,
    ``native``, ``finish``; one synchronize at the end) and the voxel-hash
    graph's ``graph`` its ``candidates`` (one host read a chunk).

    Host reads: the dedup's occupied-voxel count and the graph's valid-row
    count are read as scalars (they size the work); every array the host
    stages need comes back behind one synchronize (``_fetch``).
    """
    global DEDUP_OVERFLOWS
    k_core = min(cfg.min_cluster_size, 30)
    xyz = xyz.to(torch.float32)
    valid = valid.to(torch.bool)
    ms = {}
    clock = StageClock(ms if timed and info is not None else None,
                       xyz.device, "hdbscan")
    graph_info = {}

    def report(path, n_unique=None):
        clock.mark("end")
        clock.finish()
        if info is not None:
            info.update(path=path, n_unique=n_unique, graph=graph_info,
                        ms=ms)

    n_unique = None
    have_lib = get_lib() is not None
    if cfg.hdbscan_exact and cfg.hdbscan_dedup_voxel > 0:
        clock.mark("dedup")
        rep_xyz, rep_valid, rep_mult, point_rep, n_unique = (
            _cluster.voxel_dedup_compact(
                xyz, valid, voxel=cfg.hdbscan_dedup_voxel,
                cap=cfg.hdbscan_rep_cap))
        if n_unique > cfg.hdbscan_rep_cap:
            DEDUP_OVERFLOWS += 1
        elif have_lib:
            clock.mark("graph")
            _, edge_dst, edge_w = _cluster.exact_knn_mutual_reachability(
                rep_xyz, rep_valid, rep_mult, k=k_core,
                knn_recall=cfg.hdbscan_knn_recall, info=graph_info)
            n_rep = int(edge_dst.shape[0])
            compress = cfg.hdbscan_fetch_f16 and n_rep <= 65534
            if compress:
                edge_dst, edge_w = compress_edges(edge_dst, edge_w)
            clock.mark("fetch")
            ed, ew, mult_h, point_rep_h, rep_valid_h, valid_h = _fetch(
                edge_dst, edge_w, rep_mult.to(torch.int32),
                point_rep.to(torch.int32), rep_valid, valid)
            if compress:
                ed, ew = expand_edges(ed, ew, n_rep)
            clock.mark("native")
            rep_labels = _native_labels(ed, ew, cfg.min_cluster_size,
                                        node_w=mult_h)
            if rep_labels is not None:
                clock.mark("finish")
                rep_labels = _finish_labels(
                    rep_labels, rep_valid_h, ed, ew, cfg,
                    sizes_w=mult_h.astype(np.int64))
                # broadcast representative labels back to every point
                lab_pad = np.concatenate(
                    [rep_labels, np.full((1,), -1, np.int32)])
                out = lab_pad[np.minimum(point_rep_h, cfg.hdbscan_rep_cap)]
                out[~valid_h] = -1
                report("dedup", n_unique)
                return out.astype(np.int32)

    def dbscan_fallback():     # native library unavailable
        clock.mark("graph")
        lab = _cluster.dbscan(
            xyz, valid,
            eps=cfg.epsilon, min_points=cfg.min_cluster_size,
            num_clusters=cfg.num_clusters, cell_cap=cfg.cluster_cell_cap,
            max_iters=cfg.cluster_max_iters,
            eps_scale_per_m=max(cfg.eps_scale_per_m, 0.012),
            eps_max=cfg.eps_max)
        report("dbscan_fallback", n_unique)
        return lab.cpu().numpy()

    if not have_lib:
        return dbscan_fallback()
    clock.mark("graph")
    if cfg.hdbscan_exact:
        path = "full"
        _, edge_dst, edge_w = _cluster.exact_knn_mutual_reachability(
            xyz, valid, k=k_core, knn_recall=cfg.hdbscan_knn_recall,
            info=graph_info)
    else:
        path = "voxel_hash"
        _, edge_dst, edge_w = _cluster.mutual_reachability_edges(
            xyz, valid, k_core=k_core, edges_per_point=cfg.hdbscan_edges,
            cell_sizes=cfg.hdbscan_cells, cell_cap=cfg.hdbscan_cell_cap,
            info=graph_info if timed and info is not None else None)
    clock.mark("fetch")
    ed, ew, valid_h = _fetch(edge_dst, edge_w, valid)
    clock.mark("native")
    labels = _native_labels(ed, ew, cfg.min_cluster_size)
    if labels is None:
        return dbscan_fallback()
    clock.mark("finish")
    out = _finish_labels(labels, valid_h, ed, ew, cfg)
    report(path, n_unique)
    return out
