"""Scene-flow evaluation helpers (numpy; copies of ``compute_epe`` and
``crop_for_eval`` from ``icpflow_tpu/metrics.py``, which cannot be imported
without JAX). Ref ICP-Flow `utils_eval.py:24-63,137-182`."""

from __future__ import annotations

import numpy as np


def compute_epe(flow_pred, flow_gt, mask=None):
    """EPE3D / ACC3DS / ACC3DR / Outlier / ROutlier."""
    flow_pred = np.asarray(flow_pred)
    flow_gt = np.asarray(flow_gt)
    if mask is not None:
        m = np.asarray(mask) > 0
        flow_pred = flow_pred[m]
        flow_gt = flow_gt[m]
    epe_pp = np.linalg.norm(flow_gt - flow_pred, axis=-1)
    epe = epe_pp.mean() if epe_pp.size else 0.0
    sf_norm = np.linalg.norm(flow_gt, axis=-1)
    rel = epe_pp / (sf_norm + 1e-20)
    accs = np.logical_or(epe_pp < 0.05, rel < 0.05).mean() if epe_pp.size else 0.0
    accr = np.logical_or(epe_pp < 0.1, rel < 0.1).mean() if epe_pp.size else 0.0
    outlier = np.logical_or(epe_pp > 0.3, rel > 0.1).mean() if epe_pp.size else 0.0
    routlier = np.logical_and(epe_pp > 0.3, rel > 0.3).mean() if epe_pp.size else 0.0
    return float(epe), float(accs), float(accr), float(outlier), float(routlier)


def crop_for_eval(points, *, range_x, range_y, range_z, ground_slack,
                  eval_ground: bool):
    """Eval crop mask replicating PCAccumulation."""
    pts = np.asarray(points)
    m = np.logical_and(np.abs(pts[:, 0]) < range_x, np.abs(pts[:, 1]) < range_y)
    if not eval_ground:
        m = np.logical_and(m, pts[:, 2] > range_z + ground_slack)
    return m
