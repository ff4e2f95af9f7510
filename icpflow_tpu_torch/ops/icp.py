"""Batched masked point-to-point ICP with init-pose rollback.

Port of ``icpflow_tpu/ops/icp.py``. Each pair carries a convergence latch
(patience on the best inlier rmse), returns its best visited pose, and may
run a wide-gate coarse phase first. The reference's ``lax.while_loop`` and
its tail compaction become one eager loop in which every iteration runs
only the rows that are not yet frozen: rows are independent, and a frozen
row's pose and best pose never change, so this is the same computation.
The all-frozen exit test is one host read per iteration. A traced call
counts the iterations (``icp_iters``) and makes each a span
``icpflow.icp.iter``; the exit test's read falls in the enclosing span.
"""

from __future__ import annotations

import torch

from .. import trace as _trace
from . import geometry as geo
from . import knn as _knn


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

    eff = coarse_iters if (coarse_iters and coarse_on) else 0
    eye = torch.eye(3, dtype=f32, device=dev).expand(b, 3, 3)
    R_cur = eye.clone()
    t_cur = torch.zeros((b, 3), dtype=f32, device=dev)
    best_R = eye.clone()
    best_t = torch.zeros((b, 3), dtype=f32, device=dev)
    best_rmse = torch.full((b,), float("inf"), dtype=f32, device=dev)
    stale = torch.zeros((b,), dtype=torch.int32, device=dev)
    frozen = torch.zeros((b,), dtype=torch.bool, device=dev)

    for it in range(max_iters):
        rows = torch.nonzero(~frozen)[:, 0]
        if rows.numel() == 0:
            break
        with _trace.span("icpflow.icp.iter"):
            _trace.count("icp_iters")
            s, sm = src[rows], src_mask[rows]
            moved = torch.einsum("bij,bnj->bni", R_cur[rows], s) \
                + t_cur[rows][:, None, :]
            # only rows under ``sm`` are read below (``inlier``): the sweep
            # skips the others, which changes no bit of the result
            nn_pts, dist = _knn.masked_nn_points(
                moved, dst[rows], dst_mask[rows], tile=tile, src_mask=sm)
            fine = it >= eff
            thr = thres if fine else thres * coarse_scale
            inlier = (dist <= thr) & sm
            R, t = geo.kabsch(s, nn_pts, inlier)
            moved2 = torch.einsum("bij,bnj->bni", R, s) + t[:, None, :]
            sq = torch.sum((moved2 - nn_pts) ** 2, dim=-1)
            w = inlier.to(f32)
            rmse = torch.sqrt(torch.sum(sq * w, 1)
                              / torch.clamp(torch.sum(w, 1), min=1e-9))

            prev = best_rmse[rows]
            first = it == eff
            if fine:
                take = torch.ones_like(rmse, dtype=torch.bool) if first \
                    else rmse < prev
                meaningful = take if first else \
                    (prev - rmse) > stall_rel * torch.clamp(prev, min=1e-20)
                st = torch.where(meaningful, torch.zeros_like(stale[rows]),
                                 stale[rows] + 1)
                tk = take[:, None]
                best_R[rows] = torch.where(tk[:, :, None], R, best_R[rows])
                best_t[rows] = torch.where(tk, t, best_t[rows])
                best_rmse[rows] = torch.where(take, rmse, prev)
            else:
                st = torch.zeros_like(stale[rows])
            stale[rows] = st
            frozen[rows] = st >= patience
            R_cur[rows] = R
            t_cur[rows] = t
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
