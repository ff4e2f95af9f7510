# Frozen copy of the port's plain offline path (icpflow_tpu_torch/data/pca.py,
# data/loading.py, metrics.py and cli.py's per-sample step) for the
# benchmark's reference. It imports nothing of the program; leave it as it
# is when the program changes: it is the yardstick.
"""One PCA-format sample (a sequence of n sweeps) as the offline CLI
processes it (ICP-Flow ``dataset_pca.py:30-242``, ``main.py:156-314``):

* crop to |x| < range_x, |y| < range_y; GT flow from the GT ego poses and
  the per-instance transforms;
* stateful CZM ground over the sweeps in order, each padded to
  ``max_points_scene`` in the sensor frame;
* for each frame j >= 1: frame j moved by its GT ego pose, clustered
  jointly with frame 0 in one ``2 * max_points_scene`` bucket (ground
  points labelled ``GROUND_LABEL``), both clouds padded to their own
  power-of-two bucket, matched at ``max(speed * j, |t_j|) * 2``, and the
  flow of frame j's raw points taken with its ego pose;
* the eval crop and the category x granularity metric sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import pad_cloud
from .flow import flow_with_identity_override
from .ground import initial_ground_state, segment_ground_stateful
from .matcher import match_frame_pair
from .segments import GROUND_LABEL, extract_segments

CATEGORIES = ("overall", "static", "static_bg", "static_fg",
              "dynamic", "dynamic_fg")


# -- loading (data/loading.py, data/pca.py: _raw_from_dict) ---------------
def ego_motion_compensation(points, time_indice, tsfm):
    T = tsfm[time_indice.astype(int)]
    return np.einsum("nij,nj->ni", T[:, :3, :3], points[:, :3]) + T[:, :3, 3]


def reconstruct_sequence(points, time_indice, inst_labels, tsfm, n_frames):
    assert n_frames == tsfm.shape[1]
    idx = (inst_labels * n_frames + time_indice).astype(int)
    T = tsfm.reshape(-1, 4, 4)[idx]
    return np.einsum("nij,nj->ni", T[:, :3, :3], points[:, :3]) + T[:, :3, 3]


def load(cfg, d: dict) -> dict:
    raw, ti = d["raw_points"], d["time_indice"]
    sd, fb, inst = d["sd_labels"], d["fb_labels"], d["inst_labels"]
    ego_gt, inst_gt = d["ego_motion_gt"], d["bbox_tsfm"]
    if len(np.unique(ti)) != cfg.num_frames or len(ego_gt) != cfg.num_frames:
        raise ValueError("the sample's frame count is not the config's")
    keep = np.logical_and(np.abs(raw[:, 0]) < cfg.range_x,
                          np.abs(raw[:, 1]) < cfg.range_y)
    raw, ti = raw[keep], ti[keep]
    sd, fb, inst = sd[keep], fb[keep], inst[keep]
    pts_ego = ego_motion_compensation(raw, ti, ego_gt)
    pts_full = reconstruct_sequence(pts_ego, ti, inst, inst_gt,
                                    cfg.num_frames)
    return {"raw_points": raw.astype(np.float32), "time_indice": ti,
            "sd_labels": sd, "fb_labels": fb,
            "ego_poses": ego_gt.astype(np.float32),
            "scene_flow": (pts_full - raw[:, :3]).astype(np.float32)}


def _pad(pts: np.ndarray, cap: int):
    out = np.zeros((cap, 3), np.float32)
    n = min(len(pts), cap)
    out[:n] = pts[:n, :3]
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return out, valid


# -- metrics (metrics.py) ---------------------------------------------------
def compute_epe(flow_pred, flow_gt, mask=None):
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
    accs = np.logical_or(epe_pp < 0.05, rel < 0.05).mean() \
        if epe_pp.size else 0.0
    accr = np.logical_or(epe_pp < 0.1, rel < 0.1).mean() \
        if epe_pp.size else 0.0
    outlier = np.logical_or(epe_pp > 0.3, rel > 0.1).mean() \
        if epe_pp.size else 0.0
    routlier = np.logical_and(epe_pp > 0.3, rel > 0.3).mean() \
        if epe_pp.size else 0.0
    return (float(epe), float(accs), float(accr), float(outlier),
            float(routlier))


def meter_names(num_frames: int) -> list:
    return [f"{cat}_{k}" for cat in CATEGORIES for k in range(num_frames + 1)]


def metric_sums(flow_pred, flow_gt, sd, fb, ti, num_frames: int) -> dict:
    """Meter name -> [num, epe, accs, accr, outlier, routlier] sums of one
    sample's sweep, as ``AverageMeter.update`` accumulates them."""
    sums = {name: [0.0] * 6 for name in meter_names(num_frames)}

    def update(name, vals, num):
        s = sums[name]
        s[0] += num
        for i, v in enumerate(vals, 1):
            s[i] += v * num

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
        for cat, m in cat_masks(sd[sel], fb[sel]).items():
            if m.sum() == 0:
                continue
            update(f"{cat}_{j}", compute_epe(flow_pred[sel], flow_gt[sel], m),
                   int(m.sum()))
    sel = ti > 0
    masks = cat_masks(sd[sel], fb[sel])
    for k, weight_is_count in ((0, True), (num_frames, False)):
        for cat, m in masks.items():
            if m.sum() == 0:
                continue
            vals = compute_epe(flow_pred[sel], flow_gt[sel], m)
            w = int(m.sum()) if weight_is_count else 1
            if k == 0 and cat == "overall":
                w = len(flow_pred)      # utils_eval.py:275's weight
            update(f"{cat}_{k}", vals, w)
    return sums


# -- the sample --------------------------------------------------------------
def sample(ref, d: dict) -> dict:
    """The sample ``d`` (the npz's arrays) through the offline path on
    ``ref`` (a ``reference.engine.Reference``). Returns, for frames
    j = 1..n-1 in order, lists ``transforms``, ``pairs`` (tables),
    ``labels_src``, ``labels_dst``, and the sample's ``flow`` (frame 0's
    zeros first) and ``meters`` (``meter_names`` order, (k, 6) sums)."""
    cfg = ref.cfg
    f32, i32 = torch.float32, torch.int32
    data = load(cfg, d)
    raw, ti, poses = data["raw_points"], data["time_indice"], data["ego_poses"]

    nonground = np.zeros(len(raw), bool)
    state = initial_ground_state(ref.device)
    for j in range(cfg.num_frames):
        sel = ti == j
        pts, valid = _pad(raw[sel], cfg.max_points_scene)
        ng, state = segment_ground_stateful(
            ref.tensor(pts, f32), ref.tensor(valid, torch.bool), state,
            range_z=cfg.range_z, ground_slack=cfg.ground_slack)
        nonground[sel] = ng.cpu().numpy()[: sel.sum()]

    pts0 = raw[ti == 0, :3]
    ng0 = nonground[ti == 0]
    flows = [np.zeros((len(pts0), 3), np.float32)]
    out = {k: [] for k in ("transforms", "pairs", "labels_src",
                           "labels_dst")}
    for j in range(1, cfg.num_frames):
        ptsj = raw[ti == j, :3]
        pose = poses[j]
        src = (ptsj @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
        both = np.concatenate([pts0, src]).astype(np.float32)
        ng = np.concatenate([ng0, nonground[ti == j]])
        pts_p, valid_p = _pad(both, 2 * cfg.max_points_scene)
        ngp = np.zeros(2 * cfg.max_points_scene, bool)
        ngp[: len(both)] = ng
        lab = ref.labels(ref.tensor(pts_p, f32),
                         ref.tensor(valid_p & ngp, torch.bool))
        lab = lab.cpu().numpy()[: len(both)].astype(np.int64)
        lab[~ng] = GROUND_LABEL
        lab_dst, lab_src = lab[: len(pts0)], lab[len(pts0):]

        tf = max(cfg.speed * j, float(np.linalg.norm(pose[:3, 3]))) * 2.0
        clouds = []
        for p, lab_p in ((src, lab_src), (pts0.astype(np.float32), lab_dst)):
            pp, vp = pad_cloud(p, cfg.max_points_scene)
            lp = np.full((len(pp),), -1, np.int32)
            lp[: len(p)] = lab_p
            clouds.append((ref.tensor(pp, f32), ref.tensor(vp, torch.bool),
                           ref.tensor(lp, i32)))
        segs = [extract_segments(p, lp, v, num_labels=cfg.num_clusters,
                                 max_points=cfg.max_points)
                for p, v, lp in clouds]
        res = match_frame_pair(segs[0], segs[1], float(tf), cfg)
        raw_pad = np.zeros((len(clouds[0][0]), 3), np.float32)
        raw_pad[: len(ptsj)] = ptsj
        flow = flow_with_identity_override(
            ref.tensor(raw_pad, f32), clouds[0][2], res.transforms,
            ref.tensor(pose, f32), segs[0].pidx, res.identity_pt)
        flows.append(flow.cpu().numpy()[: len(ptsj)])
        out["transforms"].append(res.transforms.cpu().numpy())
        out["pairs"].append(ref.pairs_table(res))
        out["labels_src"].append(lab_src)
        out["labels_dst"].append(lab_dst)

    flow = np.concatenate(flows)
    if cfg.eval_ground:
        keep = np.ones(len(flow), bool)
    else:
        keep = np.logical_and(np.abs(raw[:, 0]) < cfg.range_x,
                              np.abs(raw[:, 1]) < cfg.range_y)
        keep = np.logical_and(keep, raw[:, 2] > cfg.range_z
                              + cfg.ground_slack)
    sums = metric_sums(flow[keep], data["scene_flow"][keep],
                       data["sd_labels"][keep], data["fb_labels"][keep],
                       ti[keep], cfg.num_frames)
    out["flow"] = flow
    out["meters"] = np.array([sums[n] for n in meter_names(cfg.num_frames)])
    return out
