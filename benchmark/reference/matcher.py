# Frozen copy of the port's plain path, icpflow_tpu_torch/match/matcher.py, for the
# benchmark's reference. It imports nothing of the program; leave it as
# it is when the program changes: it is the yardstick.
"""Two-stage cluster matcher (port of ``icpflow_tpu/match/matcher.py``).

Stage 1 tries the L self-pairs (joint clustering gives a static object the
same label in both frames); stage 2 tries the gated cartesian product of
the labels stage 1 left unmatched, compacted into a ``max_pairs`` bucket
(overflow is counted). Each stage splits its pairs into a small bucket
(both clusters within ``max_points_small`` points) and a large one, and
runs histogram init -> ICP with rollback -> match statistics -> acceptance
gate -> per-source-label assignment by two scatter-mins.

The reference pads each bucket to a fixed size and picks a size from a
ladder at run time; rows are independent, so the port solves exactly the
valid pairs, which the reference documents as the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import Config as PipelineConfig
from . import geometry as geo
from . import hist as _hist
from . import icp as _icp
from . import knn as _knn
from .segments import SegmentBatch
from . import gates

_INF = 1e8   # reference's "no match" fill (ICP-Flow `utils_match.py:72`)


class MatchResult(NamedTuple):
    """Per-source-label match table.

    matched (L,) bool; dst_label (L,) int32 (-1 unmatched); transforms
    (L,4,4) accepted transform or identity; stats (L,8) = error x2,
    inlier x2, ratio x2, iou x2; overflow () int64 stage-2 candidates beyond
    the buckets; identity_pt (L,P) bool per-point ego-only override.
    """
    matched: torch.Tensor
    dst_label: torch.Tensor
    transforms: torch.Tensor
    stats: torch.Tensor
    overflow: torch.Tensor
    identity_pt: torch.Tensor


def _coarse_on(translation_frame: float, cfg: PipelineConfig) -> bool:
    return bool(np.float32(translation_frame)
                >= np.float32(cfg.icp_coarse_min_tf))


def hist_icp(src_xyz, src_mask, dst_xyz, dst_mask, translation_frame,
             cfg: PipelineConfig, lxy: int = 0) -> torch.Tensor:
    """Init + ICP with the smaller cloud as source (ICP-Flow
    `utils_match.py:138-157`). ``lxy`` overrides the histogram grid."""
    n_src = torch.sum(src_mask, dim=1)
    n_dst = torch.sum(dst_mask, dim=1)
    swap = (n_src > n_dst)
    sw3 = swap[:, None, None]
    sw2 = swap[:, None]
    a_xyz = torch.where(sw3, dst_xyz, src_xyz)
    b_xyz = torch.where(sw3, src_xyz, dst_xyz)
    a_mask = torch.where(sw2, dst_mask, src_mask)
    b_mask = torch.where(sw2, src_mask, dst_mask)

    init = _hist.estimate_init_translation(
        a_xyz, a_mask, b_xyz, b_mask, translation_frame,
        bin_w=cfg.hist_bin, lxy=lxy or cfg.hist_grid_xy, lz=cfg.hist_grid_z,
        topk=cfg.hist_topk, nms_kernel=cfg.hist_nms_kernel,
        eval_tile=cfg.nn_tile, yaws=cfg.hist_yaws,
        coarse_cap=cfg.hist_coarse_cap, refine=cfg.hist_refine,
        yaw_per_m=cfg.hist_yaw_per_m, yaw_scale_cap=cfg.hist_yaw_scale_cap)
    T = _icp.apply_icp(
        a_xyz, a_mask, b_xyz, b_mask, init,
        _coarse_on(translation_frame, cfg),
        thres=cfg.thres_dist, max_iters=cfg.icp_max_iters, tile=cfg.nn_tile,
        patience=cfg.icp_patience, stall_rel=cfg.icp_stall_rel,
        corr_cap=cfg.icp_corr_cap, coarse_iters=cfg.icp_coarse_iters,
        coarse_scale=cfg.icp_coarse_scale, init_margin=cfg.icp_init_margin,
        init_margin_rel=cfg.icp_init_margin_rel)
    return torch.where(sw3, geo.invert_rigid(T), T)


def match_eval(src_xyz, src_mask, dst_xyz, dst_mask, T, cfg: PipelineConfig,
               moved=None, dist_f=None, dist_b=None):
    """Symmetric NN statistics of a transformed pair (ICP-Flow
    `utils_match.py:159-213`). With ``inlier_scale_per_m`` > 0 the inlier
    radius grows with the cluster's range. Returns (stats (B,8),
    translation (B,3), rotation_deg (B,3))."""
    if moved is None:
        moved = geo.transform_points_batch(src_xyz, T)
    # each distance is read only under the mask of the side it starts from
    # (weights, inlier counts), so the sweeps skip the other rows
    if dist_f is None:
        _, dist_f = _knn.masked_nn(moved, dst_xyz, dst_mask, tile=cfg.nn_tile,
                                   src_mask=src_mask)
    if dist_b is None:
        _, dist_b = _knn.masked_nn(dst_xyz, moved, src_mask, tile=cfg.nn_tile,
                                   src_mask=dst_mask)
    wf = src_mask.to(dist_f.dtype)
    wb = dst_mask.to(dist_b.dtype)
    n_src = torch.clamp(torch.sum(wf, 1), min=1e-9)
    n_dst = torch.clamp(torch.sum(wb, 1), min=1e-9)

    radius = cfg.thres_dist
    if cfg.inlier_scale_per_m > 0:
        c = geo.masked_mean(src_xyz, src_mask)
        rng = torch.sqrt(torch.sum(c * c, dim=-1))
        radius = torch.clamp(
            cfg.thres_dist * (1.0 + cfg.inlier_scale_per_m * rng),
            max=cfg.inlier_radius_max)[:, None]
    inl_f = torch.sum(((dist_f < radius) & src_mask).to(wf.dtype), 1)
    inl_b = torch.sum(((dist_b < radius) & dst_mask).to(wb.dtype), 1)
    ratio_f = inl_f / n_src
    ratio_b = inl_b / n_dst
    iou_f = inl_f / torch.clamp(n_src + n_dst - inl_b, min=1e-9)
    iou_b = inl_b / torch.clamp(n_src + n_dst - inl_f, min=1e-9)
    err_f = torch.sum(dist_f * wf, 1) / n_src
    err_b = torch.sum(dist_b * wb, 1) / n_dst

    mu_moved = geo.masked_mean(moved, src_mask)
    mu_src = geo.masked_mean(src_xyz, src_mask)
    translation = mu_moved - mu_src
    rotation = geo.euler_zyx_deg(T[:, :3, :3])
    stats = torch.stack(
        [err_f, err_b, inl_f, inl_b, ratio_f, ratio_b, iou_f, iou_b], dim=1)
    return stats, translation, rotation


def _solve_bucket(seg_src: SegmentBatch, seg_dst: SegmentBatch,
                  pair_src, pair_dst, translation_frame,
                  cfg: PipelineConfig, n_points: int):
    """hist_icp + eval + gate for valid pairs at ``n_points`` points
    (ICP-Flow `utils_match.py:69-136`). Returns (T, stats, accept, id_pt)."""
    n_points = min(n_points, seg_src.xyz.shape[1])
    s_xyz = seg_src.xyz[pair_src, :n_points]
    s_mask = seg_src.mask[pair_src, :n_points]
    d_xyz = seg_dst.xyz[pair_dst, :n_points]
    d_mask = seg_dst.mask[pair_dst, :n_points]

    small_lxy = (cfg.hist_grid_xy_small
                 if n_points <= cfg.max_points_small else 0)
    T = hist_icp(s_xyz, s_mask, d_xyz, d_mask, translation_frame, cfg,
                 lxy=small_lxy)
    id_pt = torch.zeros_like(s_mask)
    moved = dist_f = dist_b = None
    if cfg.identity_margin > 0 or cfg.per_point_identity:
        # NN distances under identity and under T, shared by the identity
        # preference, the per-point refinement and the match statistics;
        # read only under the mask of the side they start from, which the
        # sweeps get as their src mask (a backward sweep's is ``d_mask``)
        _, d_id = _knn.masked_nn(s_xyz, d_xyz, d_mask, tile=cfg.nn_tile,
                                 src_mask=s_mask)
        _, d_id_b = _knn.masked_nn(d_xyz, s_xyz, s_mask, tile=cfg.nn_tile,
                                   src_mask=d_mask)
        wf = s_mask.to(d_id.dtype)
        wb = d_mask.to(d_id.dtype)
        n_s = torch.clamp(torch.sum(wf, 1), min=1e-9)
        n_d = torch.clamp(torch.sum(wb, 1), min=1e-9)
        err_id = torch.minimum(torch.sum(d_id * wf, 1) / n_s,
                               torch.sum(d_id_b * wb, 1) / n_d)
        moved_T = geo.transform_points_batch(s_xyz, T)
        _, d_T = _knn.masked_nn(moved_T, d_xyz, d_mask, tile=cfg.nn_tile,
                                src_mask=s_mask)
        _, d_T_b = _knn.masked_nn(d_xyz, moved_T, s_mask, tile=cfg.nn_tile,
                                  src_mask=d_mask)
        err_T = torch.minimum(torch.sum(d_T * wf, 1) / n_s,
                              torch.sum(d_T_b * wb, 1) / n_d)
        if cfg.identity_margin > 0:
            # identity wins when it fits within the margin
            prefer_id = err_id <= err_T + cfg.identity_margin
            eye = geo.eye4(T.shape[0], T)
            T = torch.where(prefer_id[:, None, None], eye, T)
        else:
            prefer_id = torch.zeros(T.shape[:1], dtype=torch.bool,
                                    device=T.device)
        pid = prefer_id[:, None]
        moved = torch.where(prefer_id[:, None, None], s_xyz, moved_T)
        dist_f = torch.where(pid, d_id, d_T)
        dist_b = torch.where(pid, d_id_b, d_T_b)
        if cfg.per_point_identity:
            is_mover = (torch.sqrt(torch.sum(T[:, :3, 3] ** 2, dim=1))
                        > 2.0 * cfg.thres_dist) & ~prefer_id
            id_pt = (s_mask & is_mover[:, None]
                     & (d_id < cfg.thres_dist)
                     & (d_T > 2.0 * cfg.thres_dist))
    stats, translation, rotation = match_eval(
        s_xyz, s_mask, d_xyz, d_mask, T, cfg,
        moved=moved, dist_f=dist_f, dist_b=dist_b)
    accept = gates.check_transformation(
        translation, rotation, torch.minimum(stats[:, 6], stats[:, 7]),
        translation_frame=translation_frame, thres_iou=cfg.thres_iou,
        thres_rot=cfg.thres_rot, thres_z=cfg.thres_z)
    return T, stats, accept, id_pt


def _run_stage(seg_src: SegmentBatch, seg_dst: SegmentBatch,
               pair_src, pair_dst, pair_valid, translation_frame,
               cfg: PipelineConfig):
    """Size-classed solve over a (K,) pair frame. Pairs beyond the
    ``pairs_small`` / ``pairs_large`` buckets are dropped and counted.
    Returns (T (K,4,4), stats (K,8), accept (K,), dropped, id_pt (K,P))."""
    K = pair_src.shape[0]
    dev = pair_src.device
    ps = cfg.max_points_small
    P = seg_src.xyz.shape[1]
    small = pair_valid & (seg_src.count[pair_src] <= ps) \
        & (seg_dst.count[pair_dst] <= ps)
    large = pair_valid & ~small

    T = geo.eye4(K, seg_src.xyz)
    stats = torch.zeros((K, 8), dtype=torch.float32, device=dev)
    accept = torch.zeros((K,), dtype=torch.bool, device=dev)
    id_pt = torch.zeros((K, P), dtype=torch.bool, device=dev)
    kept = 0
    for mask, bucket, n_points in ((small, cfg.pairs_small, ps),
                                   (large, cfg.pairs_large, cfg.max_points)):
        rows = torch.nonzero(mask)[:, 0][:bucket]   # index order, as the
        kept += rows.numel()                         # reference's stable sort
        if rows.numel() == 0:
            continue
        Tb, sb, ab, ib = _solve_bucket(seg_src, seg_dst, pair_src[rows],
                                       pair_dst[rows], translation_frame,
                                       cfg, n_points)
        T[rows] = Tb
        stats[rows] = sb
        accept[rows] = ab
        id_pt[rows, :ib.shape[1]] = ib
    dropped = int(pair_valid.sum()) - kept
    return T, stats, accept & pair_valid, dropped, id_pt


def _assign(pair_src, err, accept, L, thres_error, idx_offset=0,
            total_pairs=None, cp_group=None):
    """Per-source-label argmin assignment with error gate (ICP-Flow
    `utils_match.py:110-121`): two scatter-mins, the second breaking ties by
    the lowest pair index. When the pair frame is one cp rank's slice,
    ``idx_offset`` makes the local pair indices global among
    ``total_pairs``, and both tables are min-reduced over ``cp_group``.
    Returns (matched (L,), chosen (L,) int64)."""
    K_total = total_pairs if total_pairs is not None else pair_src.shape[0]
    K = pair_src.shape[0]
    dev = pair_src.device
    score = torch.where(accept, err, torch.full_like(err, _INF))
    src_safe = torch.where(accept, pair_src.long(),
                           torch.full_like(pair_src.long(), L))
    best = torch.full((L + 1,), _INF, dtype=err.dtype, device=dev)
    best.scatter_reduce_(0, src_safe, score, reduce="amin")
    if cp_group is not None:
        best = cp_group.all_reduce(best, "min")
    is_best = accept & (score <= best[src_safe]) & (score < thres_error)
    gidx = torch.arange(K, device=dev) + idx_offset
    cand = torch.where(is_best, gidx, torch.full_like(gidx, K_total))
    chosen = torch.full((L + 1,), K_total, dtype=torch.int64, device=dev)
    chosen.scatter_reduce_(0, src_safe, cand, reduce="amin")
    if cp_group is not None:
        chosen = cp_group.all_reduce(chosen, "min")
    chosen = chosen[:L]
    matched = chosen < K_total
    return matched, torch.clamp(chosen, max=K_total - 1)


def match_frame_pair(seg_src: SegmentBatch, seg_dst: SegmentBatch,
                     translation_frame: float, cfg: PipelineConfig,
                     cp_group=None) -> MatchResult:
    """Full two-stage matching of one frame pair (ICP-Flow
    `utils_match.py:24-66`).

    With ``cp_group`` (a ``parallel.mesh.Axis``: ``rank``, ``size``,
    ``all_reduce``, ``all_gather``) the pair frame of each stage is split
    over the cp ranks: each solves its slice, with the ``pairs_small`` /
    ``pairs_large`` caps applying to the slice, the assignment tables are
    min-reduced, the per-pair results gathered in rank order, and the
    dropped pairs summed. The stage-2 candidate order stays global."""
    L = seg_src.xyz.shape[0]
    dev = seg_src.xyz.device
    sanity = gates.sanity_matrix(
        seg_src.count, seg_src.mean, seg_src.extent,
        seg_dst.count, seg_dst.mean, seg_dst.extent,
        min_cluster_size=cfg.min_cluster_size, thres_box=cfg.thres_box,
        translation_frame=translation_frame)

    def shard_slice(arrs, total):
        if cp_group is None:
            return arrs, 0
        per = total // cp_group.size
        if per * cp_group.size != total:
            raise ValueError(f"{total} pairs do not split over "
                             f"{cp_group.size} cp ranks")
        off = cp_group.rank * per
        return [a[off:off + per] for a in arrs], off

    def gather(x):
        return x if cp_group is None else cp_group.all_gather(x)

    # ---- stage 1: static self-pairs -------------------------------------
    iota = torch.arange(L, device=dev)
    valid1 = torch.diagonal(sanity)
    (p1, v1), off1 = shard_slice([iota, valid1], L)
    T1, stats1, accept1, dropped1, idp1 = _run_stage(
        seg_src, seg_dst, p1, p1, v1, translation_frame, cfg)
    err1 = torch.minimum(stats1[:, 0], stats1[:, 1])
    matched1, _ = _assign(p1, err1, accept1, L, cfg.thres_error,
                          idx_offset=off1, total_pairs=L, cp_group=cp_group)
    T1, stats1, idp1 = gather(T1), gather(stats1), gather(idp1)

    # ---- stage 2: dynamic cartesian leftovers ---------------------------
    left_src = (seg_src.count > 0) & ~matched1
    left_dst = (seg_dst.count > 0) & ~matched1   # stage-1 pairs are (l, l)
    flat = (sanity & left_src[:, None] & left_dst[None, :]).reshape(-1)
    K2 = cfg.max_pairs
    cand = torch.nonzero(flat)[:, 0]
    overflow = max(cand.numel() - K2, 0)
    order = torch.cat([cand, torch.nonzero(~flat)[:, 0]])[:K2]
    valid2 = flat[order]
    pair_src2 = order // L
    pair_dst2 = order % L
    (p2, d2, v2), off2 = shard_slice([pair_src2, pair_dst2, valid2], K2)
    T2, stats2, accept2, dropped2, idp2 = _run_stage(
        seg_src, seg_dst, p2, d2, v2, translation_frame, cfg)
    err2 = torch.minimum(stats2[:, 0], stats2[:, 1])
    matched2, chosen2 = _assign(
        p2, err2, accept2, L, cfg.thres_error, idx_offset=off2,
        total_pairs=None if cp_group is None else K2, cp_group=cp_group)
    T2, stats2, idp2 = gather(T2), gather(stats2), gather(idp2)

    # ---- combine: stage-1 winners keep their match ----------------------
    eye = geo.eye4(L, T1)
    m1, m2 = matched1, matched2
    transforms = torch.where(m1[:, None, None], T1,
                             torch.where(m2[:, None, None], T2[chosen2], eye))
    stats = torch.where(m1[:, None], stats1,
                        torch.where(m2[:, None], stats2[chosen2],
                                    torch.zeros_like(stats1)))
    dst_label = torch.where(m1, iota, torch.where(m2, pair_dst2[chosen2],
                                                  torch.full_like(iota, -1)))
    identity_pt = torch.where(m1[:, None], idp1,
                              m2[:, None] & idp2[chosen2])
    dropped = dropped1 + dropped2
    if cp_group is not None:
        dropped = int(cp_group.all_reduce(
            torch.tensor([dropped], device=dev), "sum")[0])
    return MatchResult(
        matched=m1 | m2, dst_label=dst_label.to(torch.int32),
        transforms=transforms, stats=stats,
        overflow=torch.tensor(overflow + dropped),
        identity_pt=identity_pt)
