"""SceneFlowEngine: clustering -> segments -> two-stage matching -> flow.

Port of ``icpflow_tpu/models/icp_flow.py`` for one explicit torch device.
``run_pair`` is the main path: joint clustering over dst u src (DBSCAN,
or hdbscan with ``use_hdbscan``), segment
extraction, the matcher, and flow assembly, run eagerly on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, StageClock, resolve_device
from ..flow import flow_from_transforms, flow_with_identity_override
from ..match.matcher import MatchResult, match_frame_pair
from ..ops import cluster as _cluster
from ..ops.hdbscan import hdbscan
from ..ops.segments import SegmentBatch, extract_segments


class TrackOutput(NamedTuple):
    result: MatchResult
    seg_src: SegmentBatch
    seg_dst: SegmentBatch


class FusedPairOutput(NamedTuple):
    flow: torch.Tensor        # (N_src, 3)
    track: TrackOutput
    lab_src: torch.Tensor     # (N_src,) int32
    lab_dst: torch.Tensor     # (N_dst,) int32


def joint_labels(pts: torch.Tensor, valid: torch.Tensor,
                 cfg: PipelineConfig, info: Optional[dict] = None,
                 timed: bool = False) -> torch.Tensor:
    """Config-routed clusterer over one padded cloud. Returns (N,) int32
    labels on the cloud's device.

    ``use_hdbscan``: ``ops.hdbscan.hdbscan`` (``info``, when given, receives
    its path and voxel count, and with ``timed`` its stage milliseconds).
    Otherwise raw-cloud
    dbscan, or its voxel-dedup form (``cluster_dedup_voxel > 0``) with
    weighted counts and its fallback to the full cloud."""
    if cfg.use_hdbscan:
        lab = hdbscan(pts, valid, cfg, info=info, timed=timed)
        return torch.as_tensor(lab).to(pts.device)
    kw = dict(eps=cfg.epsilon, min_points=cfg.min_cluster_size,
              num_clusters=cfg.num_clusters, cell_cap=cfg.cluster_cell_cap,
              max_iters=cfg.cluster_max_iters,
              eps_scale_per_m=cfg.eps_scale_per_m, eps_max=cfg.eps_max)
    if cfg.cluster_dedup_voxel > 0:
        return _cluster.dbscan_dedup(
            pts, valid, dedup_voxel=cfg.cluster_dedup_voxel,
            rep_cap=cfg.cluster_rep_cap, **kw)
    return _cluster.dbscan(pts, valid, **kw)


class SceneFlowEngine:
    """End-to-end ICP-Flow pipeline on one torch device.

    Runs on the GPU unless the caller passes another ``device`` ("cpu": the
    plain PyTorch versions of the kernels). A CUDA device on a machine
    without a usable GPU raises ``RuntimeError``; the engine never moves
    work to the CPU on its own.
    """

    def __init__(self, cfg: PipelineConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        # what the last ``cluster_joint`` reported (hdbscan: its path and
        # voxel count, and its stage milliseconds when timed; see
        # ``joint_labels``)
        self.cluster_info: dict = {}

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def cluster_joint(self, pts_dst, valid_dst, pts_src_ego, valid_src,
                      timed: bool = False):
        """Cluster dst u src jointly so static objects share labels.
        Returns (labels_dst, labels_src) int32 in one label space, on the
        engine's device. ``timed`` adds the clusterer's stage milliseconds
        to ``cluster_info`` (CUDA events and a synchronize)."""
        pts = torch.cat([self._tensor(pts_dst, torch.float32),
                         self._tensor(pts_src_ego, torch.float32)])
        valid = torch.cat([self._tensor(valid_dst, torch.bool),
                           self._tensor(valid_src, torch.bool)])
        self.cluster_info = {}
        labels = joint_labels(pts, valid, self.cfg, info=self.cluster_info,
                              timed=timed)
        n0 = len(pts_dst)
        return labels[:n0], labels[n0:]

    def track_pair(self, pts_src, valid_src, labels_src, pts_dst, valid_dst,
                   labels_dst, translation_frame: float) -> TrackOutput:
        """Match all cluster pairs of one (ego-aligned) frame pair."""
        cfg = self.cfg
        segs = [extract_segments(self._tensor(p, torch.float32),
                                 self._tensor(lab, torch.int32),
                                 self._tensor(v, torch.bool),
                                 num_labels=cfg.num_clusters,
                                 max_points=cfg.max_points)
                for p, v, lab in ((pts_src, valid_src, labels_src),
                                  (pts_dst, valid_dst, labels_dst))]
        result = match_frame_pair(segs[0], segs[1], float(translation_frame),
                                  cfg)
        return TrackOutput(result, segs[0], segs[1])

    def flow(self, raw_src_points, labels_src, transforms, pose,
             seg_pidx=None, identity_pt=None) -> torch.Tensor:
        """Per-point flow from per-cluster transforms; with ``seg_pidx`` and
        ``identity_pt`` the matcher's per-point ego-only overrides apply."""
        pts = self._tensor(raw_src_points, torch.float32)
        lab = self._tensor(labels_src, torch.int32)
        pose = self._tensor(pose, torch.float32)
        if seg_pidx is not None and identity_pt is not None:
            return flow_with_identity_override(pts, lab, transforms, pose,
                                               seg_pidx, identity_pt)
        return flow_from_transforms(pts, lab, transforms, pose)

    def run_pair(self, pts_src, valid_src, pts_dst, valid_dst,
                 translation_frame: float, pose=None,
                 timings: Optional[dict] = None) -> FusedPairOutput:
        """The main path for one ego-aligned frame pair: joint clustering,
        matching, flow. ``timings``, when given, receives the milliseconds
        of the ``cluster``, ``track`` and ``flow`` stages, and
        ``cluster_info`` the clusterer's own; the call is then traced as
        ``icpflow.pair`` unless a traced call is already open."""
        if pose is None:
            pose = np.eye(4, dtype=np.float32)
        with StageClock(timings, self.device, "pair") as clock:
            clock.mark("cluster")
            lab_dst, lab_src = self.cluster_joint(
                pts_dst, valid_dst, pts_src, valid_src,
                timed=timings is not None)
            clock.mark("track")
            out = self.track_pair(pts_src, valid_src, lab_src, pts_dst,
                                  valid_dst, lab_dst, translation_frame)
            clock.mark("flow")
            flow = self.flow(pts_src, lab_src, out.result.transforms, pose,
                             seg_pidx=out.seg_src.pidx,
                             identity_pt=out.result.identity_pt)
            clock.mark("end")
            clock.finish()
        return FusedPairOutput(flow, out, lab_src, lab_dst)

    # -- host helpers -----------------------------------------------------
    def pad_cloud(self, pts: np.ndarray, labels: Optional[np.ndarray] = None,
                  bucket="auto"):
        """Pad an (n,3) host cloud to a scene bucket.

        ``bucket="auto"``: the smallest power of two >= n (floor 2048, cap
        ``cfg.max_points_scene``); ``None``: ``cfg.max_points_scene``; an
        int: exactly that. The bucket sets the clusterer's caps, so it is
        part of the result.
        """
        n = len(pts)
        hard_cap = self.cfg.max_points_scene
        if n > hard_cap:
            raise ValueError(f"cloud of {n} points exceeds bucket {hard_cap}")
        if bucket == "auto":
            cap = 2048
            while cap < n:
                cap *= 2
            cap = min(cap, hard_cap)
        elif bucket is None:
            cap = hard_cap
        else:
            cap = int(bucket)
            if n > cap:
                raise ValueError(f"cloud of {n} points exceeds bucket {cap}")
        out = np.zeros((cap, 3), np.float32)
        out[:n] = pts[:, :3]
        valid = np.zeros((cap,), bool)
        valid[:n] = True
        if labels is None:
            return out, valid
        lab = np.full((cap,), -1, np.int32)
        lab[:n] = labels
        return out, valid, lab

    def pairs_array(self, result: MatchResult) -> np.ndarray:
        """Host (K,10) pairs table: src_label, dst_label, error x2,
        inlier x2, ratio x2, iou x2 (ICP-Flow `utils_match.py:123-128`)."""
        matched = result.matched.cpu().numpy()
        idx = np.flatnonzero(matched)
        stats = result.stats.cpu().numpy()[idx]
        dst = result.dst_label.cpu().numpy()[idx]
        return np.concatenate(
            [idx[:, None].astype(np.float32),
             dst[:, None].astype(np.float32),
             stats.astype(np.float32)], axis=1)
