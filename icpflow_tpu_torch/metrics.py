"""Scene-flow evaluation: EPE suites, running meters, eval crop.

Numpy copy of ``icpflow_tpu/metrics.py`` (which cannot be imported without
JAX): the definitions of ICP-Flow `utils_eval.py:137-182`, the category x
granularity sweep of `utils_eval.py:185-368` and the crop protocol of
`utils_eval.py:24-63`, plus ``compute_epe_sums``, the torch form of the
point-wise metrics for accumulation on the device (the reference's
AverageMeter is weighted-sum accumulation, which maps 1:1 onto a sum of
(value*num, num) pairs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

CATEGORIES = ("overall", "static", "static_bg", "static_fg",
              "dynamic", "dynamic_fg")


def compute_epe(flow_pred, flow_gt, mask=None):
    """EPE3D / ACC3DS / ACC3DR / Outlier / ROutlier. Ref utils_eval.py:137-182."""
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


@dataclasses.dataclass
class AverageMeter:
    """Weighted running means. Ref utils_eval.py:82-135."""
    num: float = 0.0
    epe_sum: float = 0.0
    accs_sum: float = 0.0
    accr_sum: float = 0.0
    outlier_sum: float = 0.0
    routlier_sum: float = 0.0

    def update(self, epe, accs, accr, outlier, routlier, num):
        self.num += num
        self.epe_sum += epe * num
        self.accs_sum += accs * num
        self.accr_sum += accr * num
        self.outlier_sum += outlier * num
        self.routlier_sum += routlier * num

    def _avg(self, s):
        return s / self.num if self.num > 0 else 0.0

    @property
    def epe_avg(self): return self._avg(self.epe_sum)
    @property
    def accs_avg(self): return self._avg(self.accs_sum)
    @property
    def accr_avg(self): return self._avg(self.accr_sum)
    @property
    def outlier_avg(self): return self._avg(self.outlier_sum)
    @property
    def routlier_avg(self): return self._avg(self.routlier_sum)

    def merge_sums(self, sums: np.ndarray):
        """Merge a (6,) [num, epe, accs, accr, outlier, routlier] sum vector
        (e.g. psum-reduced across hosts) into this meter."""
        self.num += sums[0]
        self.epe_sum += sums[1]
        self.accs_sum += sums[2]
        self.accr_sum += sums[3]
        self.outlier_sum += sums[4]
        self.routlier_sum += sums[5]


def make_meters(num_frames: int) -> Dict[str, AverageMeter]:
    """Category x granularity meter table. Ref main.py:173-181."""
    return {f"{cat}_{k}": AverageMeter()
            for cat in CATEGORIES for k in range(num_frames + 1)}


def meters_to_state(meters: Dict[str, AverageMeter]) -> dict:
    """JSON-serialisable snapshot of a meter table (for mid-run resume —
    the reference has no meter checkpointing, SURVEY §5)."""
    return {name: dataclasses.asdict(m) for name, m in meters.items()}


def meters_from_state(state: dict, num_frames: int) -> Dict[str, AverageMeter]:
    meters = make_meters(num_frames)
    for name, fields in state.items():
        if name in meters:
            meters[name] = AverageMeter(**fields)
    return meters


def crop_for_eval(points, *, range_x, range_y, range_z, ground_slack,
                  eval_ground: bool):
    """Eval crop mask replicating PCAccumulation. Ref utils_eval.py:24-63."""
    pts = np.asarray(points)
    m = np.logical_and(np.abs(pts[:, 0]) < range_x, np.abs(pts[:, 1]) < range_y)
    if not eval_ground:
        m = np.logical_and(m, pts[:, 2] > range_z + ground_slack)
    return m


def update_metrics(meters: Dict[str, AverageMeter], *, flow_pred, flow_gt,
                   sd_labels, fb_labels, time_indice, num_frames: int):
    """Per-frame + all-points + per-scene metric sweep.

    Ref `utils_eval.py:185-368`: for each frame j in 1..num_frames-1 the six
    category masks update ``<cat>_j``; the all-points pass (time>0) updates
    ``<cat>_0`` weighted by point count; the per-scene pass updates
    ``<cat>_{num_frames}`` with weight 1.
    """
    flow_pred = np.asarray(flow_pred)
    flow_gt = np.asarray(flow_gt)
    sd = np.asarray(sd_labels)
    fb = np.asarray(fb_labels)
    ti = np.asarray(time_indice)

    def cat_masks(sd_j, fb_j):
        return {
            "overall": np.ones_like(sd_j, bool),
            "static": sd_j == 0,
            "static_bg": np.logical_and(sd_j == 0, fb_j == 0),
            "static_fg": np.logical_and(sd_j == 0, fb_j == 1),
            "dynamic": sd_j == 1,
            "dynamic_fg": np.logical_and(sd_j == 1, fb_j == 1),
        }

    for j in range(1, num_frames):
        sel = ti == j
        masks = cat_masks(sd[sel], fb[sel])
        for cat, m in masks.items():
            if m.sum() == 0:
                continue
            vals = compute_epe(flow_pred[sel], flow_gt[sel], m)
            meters[f"{cat}_{j}"].update(*vals, int(m.sum()))

    sel = ti > 0
    masks = cat_masks(sd[sel], fb[sel])
    for k, weight_is_count in ((0, True), (num_frames, False)):
        for cat, m in masks.items():
            if m.sum() == 0:
                continue
            vals = compute_epe(flow_pred[sel], flow_gt[sel], m)
            w = int(m.sum()) if weight_is_count else 1
            if k == 0 and cat == "overall":
                # quirk preserved: overall_0 is weighted by the full sequence
                # length including frame 0 (utils_eval.py:275)
                w = len(flow_pred)
            meters[f"{cat}_{k}"].update(*vals, w)
    return meters


def report(meters: Dict[str, AverageMeter], num_frames: int) -> str:
    lines = []
    for k in range(num_frames + 1):
        for cat in CATEGORIES:
            m = meters[f"{cat}_{k}"]
            lines.append(
                f"{cat+'_'+str(k):14s} EPE3D: {m.epe_avg:.6f}  "
                f"ACC3DS: {m.accs_avg:.6f}  ACC3DR: {m.accr_avg:.6f}  "
                f"Outlier: {m.outlier_avg:.6f}  Routlier: {m.routlier_avg:.6f}")
    return "\n".join(lines)


def compute_epe_sums(flow_pred, flow_gt, weights):
    """Device-side (6,) metric sums [num, epe, accs, accr, outlier, routlier].

    The torch form of `compute_epe` for accumulation on the tensors' device
    (`utils_eval.py:137-182` definitions); merge into host meters with
    ``AverageMeter.merge_sums``.
    """
    w = weights.to(flow_pred.dtype)
    err = torch.linalg.vector_norm(flow_gt - flow_pred, dim=-1)
    sf = torch.linalg.vector_norm(flow_gt, dim=-1)
    rel = err / (sf + 1e-20)
    accs = ((err < 0.05) | (rel < 0.05)).to(w.dtype)
    accr = ((err < 0.1) | (rel < 0.1)).to(w.dtype)
    outl = ((err > 0.3) | (rel > 0.1)).to(w.dtype)
    routl = ((err > 0.3) & (rel > 0.3)).to(w.dtype)
    return torch.stack([
        torch.sum(w), torch.sum(err * w), torch.sum(accs * w),
        torch.sum(accr * w), torch.sum(outl * w), torch.sum(routl * w)])
