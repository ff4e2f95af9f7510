"""The reference's two entries, in plain PyTorch over the frozen copies
beside this file: a frame pair as ``pipeline.run_frame_pair`` computes it,
and a scan stream as ``StreamingEngine(cfg, estimate_ego=True).process``
does (odometry against its own map, CZM ground, joint clustering with the
previous frame, matching, flow). Each works out everything from the raw
clouds it is given; nothing comes from the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cluster as _cluster
from .config import Config
from .ego import EgoOdometry
from .flow import flow_with_identity_override
from .ground import segment_ground
from .matcher import match_frame_pair
from .segments import extract_segments


def use_tf32(on: bool):
    """Float32 matmuls in full precision (the configurations' ``float32``)
    or, for the control, in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def pad_cloud(pts: np.ndarray, hard_cap: int):
    """(cap, 3) float32 and (cap,) bool: the smallest power of two >= n,
    at least 2048 and at most ``hard_cap`` (the bucket is part of the
    result: it sets the clusterer's caps)."""
    n = len(pts)
    if n > hard_cap:
        raise ValueError(f"cloud of {n} points exceeds bucket {hard_cap}")
    cap = 2048
    while cap < n:
        cap *= 2
    cap = min(cap, hard_cap)
    out = np.zeros((cap, 3), np.float32)
    out[:n] = pts[:, :3]
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return out, valid


class Reference:
    """One configuration's reference on one device."""

    def __init__(self, keys: dict, device):
        self.cfg = Config(keys)
        self.device = torch.device(device)

    def tensor(self, x, dtype):
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def labels(self, pts, valid):
        cfg = self.cfg
        kw = dict(eps=cfg.epsilon, min_points=cfg.min_cluster_size,
                  num_clusters=cfg.num_clusters, cell_cap=cfg.cluster_cell_cap,
                  max_iters=cfg.cluster_max_iters,
                  eps_scale_per_m=cfg.eps_scale_per_m, eps_max=cfg.eps_max)
        if cfg.use_hdbscan:
            raise ValueError("the reference has no hdbscan")
        if cfg.cluster_dedup_voxel > 0:
            return _cluster.dbscan_dedup(
                pts, valid, dedup_voxel=cfg.cluster_dedup_voxel,
                rep_cap=cfg.cluster_rep_cap, **kw)
        return _cluster.dbscan(pts, valid, **kw)

    def pair(self, pts_src, valid_src, pts_dst, valid_dst,
             translation_frame: float, pose: np.ndarray, track_valid=None):
        """Padded clouds in, (flow, match result, labels src, labels dst)
        out. The clouds are clustered under ``valid_*`` and matched under
        ``track_valid`` (src, dst), by default the same masks."""
        cfg = self.cfg
        f32, i32, b = torch.float32, torch.int32, torch.bool
        ps, vs = self.tensor(pts_src, f32), self.tensor(valid_src, b)
        pd, vd = self.tensor(pts_dst, f32), self.tensor(valid_dst, b)
        lab = self.labels(torch.cat([pd, ps]), torch.cat([vd, vs]))
        lab_dst, lab_src = lab[:len(pd)], lab[len(pd):]
        ts, td = (vs, vd) if track_valid is None else track_valid
        segs = [extract_segments(p, l.to(i32), v,
                                 num_labels=cfg.num_clusters,
                                 max_points=cfg.max_points)
                for p, v, l in ((ps, ts, lab_src), (pd, td, lab_dst))]
        res = match_frame_pair(segs[0], segs[1], float(translation_frame), cfg)
        flow = flow_with_identity_override(
            ps, lab_src.to(i32), res.transforms, self.tensor(pose, f32),
            segs[0].pidx, res.identity_pt)
        return flow, res, lab_src, lab_dst

    @staticmethod
    def pairs_table(res) -> np.ndarray:
        """(K, 10): src label, dst label, error x2, inlier x2, ratio x2,
        iou x2 of the matched source labels."""
        idx = np.flatnonzero(res.matched.cpu().numpy())
        stats = res.stats.cpu().numpy()[idx]
        dst = res.dst_label.cpu().numpy()[idx]
        return np.concatenate([idx[:, None].astype(np.float32),
                               dst[:, None].astype(np.float32),
                               stats.astype(np.float32)], axis=1)

    def frame_pair(self, point_src: np.ndarray, point_dst: np.ndarray,
                   translation_frame: float) -> dict:
        """One ego-aligned frame pair, identity pose."""
        cap = self.cfg.max_points_scene
        ps, vs = pad_cloud(point_src, cap)
        pd, vd = pad_cloud(point_dst, cap)
        flow, res, lab_src, lab_dst = self.pair(
            ps, vs, pd, vd, translation_frame, np.eye(4, dtype=np.float32))
        n, m = len(point_src), len(point_dst)
        return dict(flow=flow.cpu().numpy()[:n],
                    pairs=self.pairs_table(res),
                    transforms=res.transforms.cpu().numpy(),
                    labels_src=lab_src.cpu().numpy()[:n],
                    labels_dst=lab_dst.cpu().numpy()[:m])

    def stream(self, scans) -> list:
        """One session from a fresh map: for each scan, None for the first
        and then the dict of flow, pose, pairs and labels of the new frame."""
        cfg = self.cfg
        odo = EgoOdometry(cfg, self.device)
        prev, out = None, []
        for scan in scans:
            scan = np.asarray(scan, np.float32)[:, :3]
            pose = np.asarray(odo.register_frame(scan), np.float32)
            world = scan @ pose[:3, :3].T + pose[:3, 3]
            p, v = pad_cloud(world, cfg.max_points_scene)
            pts = self.tensor(p, torch.float32)
            valid = self.tensor(v, torch.bool)
            ng = segment_ground(pts, valid, range_z=cfg.range_z,
                                ground_slack=cfg.ground_slack)
            cur, prev_ = (pts, valid, ng), prev
            prev = cur
            if prev_ is None:
                out.append(None)
                continue
            flow, res, lab_src, _ = self.pair(
                pts, valid & ng, prev_[0], prev_[1] & prev_[2],
                cfg.translation_frame(1), np.eye(4, dtype=np.float32),
                track_valid=(valid, prev_[1]))
            n = len(scan)
            out.append(dict(flow=flow.cpu().numpy()[:n], pose=pose,
                            pairs=self.pairs_table(res),
                            labels=lab_src.cpu().numpy()[:n]))
        return out
