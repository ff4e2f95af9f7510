# Frozen copy of the port's plain path, icpflow_tpu_torch/match/gates.py, for the
# benchmark's reference. It imports nothing of the program; leave it as
# it is when the program changes: it is the yardstick.
"""Vectorised pair gating (port of ``icpflow_tpu/match/gates.py``)."""

from __future__ import annotations

import torch


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def sanity_matrix(src_count, src_mean, src_extent,
                  dst_count, dst_mean, dst_extent, *,
                  min_cluster_size: int, thres_box: float,
                  translation_frame: float) -> torch.Tensor:
    """(L_src, L_dst) matchability of every label pair (ICP-Flow
    `utils_check.py:21-49`): both clusters at least ``min_cluster_size``
    points, xy centroid shift within ``translation_frame``, and each sorted
    bbox side within a ``thres_box`` ratio of its counterpart."""
    ok_size = (torch.minimum(src_count[:, None], dst_count[None, :])
               >= min_cluster_size)
    d_xy = _norm(dst_mean[None, :, :2] - src_mean[:, None, :2])
    ok_shift = d_xy <= translation_frame
    lo = torch.minimum(src_extent[:, None, :], dst_extent[None, :, :])
    hi = torch.maximum(src_extent[:, None, :], dst_extent[None, :, :])
    ok_box = torch.all(lo >= thres_box * hi, dim=-1)
    return ok_size & ok_shift & ok_box


def check_transformation(translation: torch.Tensor,
                         rotation_deg: torch.Tensor, iou_min: torch.Tensor,
                         *, translation_frame: float, thres_iou: float,
                         thres_rot: float,
                         thres_z: float = 0.0) -> torch.Tensor:
    """Post-ICP acceptance per pair, (K,) bool (ICP-Flow
    `utils_check.py:51-66`, plus the optional vertical-shift gate)."""
    ok_t = _norm(translation) <= translation_frame
    ok_iou = iou_min >= thres_iou
    ok_rot = torch.amax(torch.abs(rotation_deg[:, 1:3]), dim=-1) \
        <= thres_rot * 90.0
    ok = ok_t & ok_iou & ok_rot
    if thres_z > 0:
        ok = ok & (torch.abs(translation[:, 2]) <= thres_z)
    return ok
