"""PCAccumulation-format dataset (Waymo / nuScenes).

Re-implements `dataset_pca.py:15-242`: per-sample npz with raw_points /
time_indice / sd/fb/inst labels / GT ego and per-instance motion; crops the
scene to +-range_x/y, reconstructs GT flow from the GT transforms, runs
ground removal per frame and *joint* two-frame clustering (frame j aligned by
its ego pose onto frame 0 so matching static objects share labels,
`dataset_pca.py:164-201`).

Port of ``icpflow_tpu/data/pca.py``. Preprocessing is host-orchestrated but
device-computed: ground segmentation (`ops/ground.py`) and DBSCAN
(`ops/cluster.py`) run on ``device`` over fixed-size buckets; KISS-style ego
estimation (`ops/ego.py`) is used when ``cfg.use_kiss_icp`` and GT poses
otherwise (`dataset_pca.py:234-237`), with the same per-sample ``*_pose``
npz caching (`dataset_pca.py:115-135`).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, StageClock, resolve_device
from ..models.icp_flow import joint_labels
from ..ops.segments import GROUND_LABEL
from .loading import PrefetchIterMixin


def _pad(pts: np.ndarray, cap: int):
    """The cloud in a ``cap`` bucket and its valid mask. A cloud past the
    bucket raises: cutting it would cluster and match other points."""
    n = len(pts)
    if n > cap:
        raise ValueError(f"cloud of {n} points exceeds bucket {cap}: raise "
                         f"max_points_scene")
    out = np.zeros((cap, 3), np.float32)
    out[:n] = pts[:, :3]
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return out, valid


class DatasetPCA(PrefetchIterMixin):
    """Iterable over PCA-format sequences; yields the reference's sample
    tuple (data dict, per-pair src/dst points and labels,
    `dataset_pca.py:230-242`). ``iter_samples`` (PrefetchIterMixin) overlaps
    native npz decode with device compute.

    Preprocesses on the GPU unless the caller passes another ``device``
    ("cpu": the plain PyTorch versions of the kernels); a CUDA device on a
    machine without a usable GPU raises ``RuntimeError``. ``timings``, when
    set to a dict, receives the milliseconds of each sample's ``load``,
    ``ground``, ``ego`` and ``cluster`` stages."""

    def __init__(self, cfg: PipelineConfig, root: str, split: str,
                 manifest_dir: str = "assets/configs/datasets",
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timings = None
        self.root = root
        self.split = split
        info = os.path.join(manifest_dir, cfg.dataset, f"{split}_info.txt")
        if not os.path.exists(info):
            # shipped manifests (reference assets/configs/datasets/*): the
            # exact waymo/nuscene sequence splits (4031/2974 test seqs)
            repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            shipped = os.path.join(repo_root, manifest_dir, cfg.dataset,
                                   f"{split}_info.txt")
            if os.path.exists(shipped):
                info = shipped
        self.seq_paths: List[str] = []
        if os.path.exists(info):
            names = np.loadtxt(info, dtype=str).tolist()
            paths = [root + n for n in names]
            # use the manifest only when it matches the data root (the
            # shipped manifests name /waymo/test/... style paths); synthetic
            # fixture roots fall through to the glob below
            if paths and os.path.exists(paths[0]):
                self.seq_paths = paths
        if not self.seq_paths:
            import glob
            # fallback glob; exclude our own outputs (flow dumps, pose caches)
            self.seq_paths = sorted(
                p for p in glob.glob(os.path.join(root, "*.npz"))
                if "_icp_flow" not in p and "_pose" not in p
                and not os.path.basename(p).startswith("metrics_"))

    def __len__(self):
        return len(self.seq_paths)

    # -- raw load + crop + GT flow (dataset_pca.py:30-113) -----------------
    def load_raw(self, path: str) -> Dict[str, np.ndarray]:
        from .native_loader import load_npz
        return self._raw_from_dict(load_npz(path), path)

    def _raw_from_dict(self, d, path: str) -> Dict[str, np.ndarray]:
        from .loading import ego_motion_compensation, reconstruct_sequence

        cfg = self.cfg
        raw_points, time_indice = d["raw_points"], d["time_indice"]
        sd, fb = d["sd_labels"], d["fb_labels"]
        inst = d["inst_labels"]
        ego_gt, inst_gt = d["ego_motion_gt"], d["bbox_tsfm"]
        assert ego_gt.shape[0] == len(np.unique(time_indice))
        assert len(np.unique(time_indice)) == cfg.num_frames

        keep = np.logical_and(np.abs(raw_points[:, 0]) < cfg.range_x,
                              np.abs(raw_points[:, 1]) < cfg.range_y)
        raw_points, time_indice = raw_points[keep], time_indice[keep]
        sd, fb, inst = sd[keep], fb[keep], inst[keep]

        pts_ego = ego_motion_compensation(raw_points, time_indice, ego_gt)
        pts_full = reconstruct_sequence(
            pts_ego, time_indice, inst, inst_gt, cfg.num_frames)
        scene_flow = pts_full - raw_points[:, :3]
        return {
            "raw_points": raw_points.astype(np.float32),
            "time_indice": time_indice,
            "sd_labels": sd,
            "fb_labels": fb,
            "ego_motion_gt": ego_gt.astype(np.float32),
            "scene_flow": scene_flow.astype(np.float32),
            "data_path": path,
        }

    # -- ground removal per frame (dataset_pca.py:152-161) -----------------
    def ground_removal(self, data) -> np.ndarray:
        """Per-frame Patchwork-style segmentation with the adaptive A-GLE /
        TGR state threaded across the sequence's frames (patchwork++'s true
        cross-frame semantics, patchworkpp.cpp:321-358; note the reference
        wrapper re-initialises per frame, utils_ground.py:52-58 — carrying
        the state is this framework's fidelity-to-upstream extension)."""
        from ..ops.ground import initial_ground_state, segment_ground_stateful

        cfg = self.cfg
        nonground = np.zeros(len(data["raw_points"]), bool)
        state = initial_ground_state(self.device)
        for j in range(cfg.num_frames):
            sel = data["time_indice"] == j
            pts, valid = _pad(data["raw_points"][sel], cfg.max_points_scene)
            ng, state = segment_ground_stateful(
                torch.as_tensor(pts).to(self.device),
                torch.as_tensor(valid).to(self.device), state,
                range_z=cfg.range_z, ground_slack=cfg.ground_slack)
            nonground[sel] = ng.cpu().numpy()[: sel.sum()]
        return nonground

    # -- ego poses: GT or cached KISS-style estimate -----------------------
    def ego_poses(self, data) -> np.ndarray:
        cfg = self.cfg
        if not cfg.use_kiss_icp:
            return data["ego_motion_gt"]
        path = data["data_path"]
        for folder in ("train", "val", "test"):
            if folder in path:
                pose_path = path.replace(folder, folder + "_pose")
                break
        else:
            pose_path = path + "_pose.npz"
        if os.path.isfile(pose_path):
            return np.load(pose_path, allow_pickle=True)["ego_motion"]
        from ..ops.ego import EgoOdometry
        odo = EgoOdometry(cfg, self.device)
        for j in range(cfg.num_frames):
            frame = data["raw_points"][data["time_indice"] == j, :3]
            odo.register_frame(frame)
        poses = np.stack(odo.poses)
        os.makedirs(os.path.dirname(pose_path), exist_ok=True)
        np.savez_compressed(pose_path, ego_motion=poses)
        return poses

    # -- joint two-frame clustering (dataset_pca.py:164-201) ---------------
    def cluster_pairs(self, data, ego_poses, nonground):
        cfg = self.cfg
        ti = data["time_indice"]
        pts0 = data["raw_points"][ti == 0, :3]
        ng0 = nonground[ti == 0]
        out = []
        for j in range(1, cfg.num_frames):
            ptsj = data["raw_points"][ti == j, :3]
            pose = ego_poses[j]
            ptsj_ego = ptsj @ pose[:3, :3].T + pose[:3, 3]
            both = np.concatenate([pts0, ptsj_ego]).astype(np.float32)
            ng = np.concatenate([ng0, nonground[ti == j]])

            pts_p, valid_p = _pad(both, 2 * cfg.max_points_scene)
            ngp = np.zeros(2 * cfg.max_points_scene, bool)
            ngp[: len(both)] = ng
            lab = joint_labels(
                torch.as_tensor(pts_p).to(self.device),
                torch.as_tensor(valid_p & ngp).to(self.device),
                cfg).cpu().numpy()[: len(both)]
            lab = lab.astype(np.int64)
            lab[~ng] = GROUND_LABEL
            out.append({
                "point_src": ptsj_ego.astype(np.float32),
                "point_dst": pts0.astype(np.float32),
                "label_src": lab[len(pts0):],
                "label_dst": lab[: len(pts0)],
            })
        return out

    def _prepare(self, data, clock=None):
        clock = clock or StageClock(self.timings, self.device,
                                    "offline.sample")
        clock.mark("ground")
        nonground = self.ground_removal(data)
        clock.mark("ego")
        ego_poses = self.ego_poses(data)
        data["ego_poses"] = ego_poses
        clock.mark("cluster")
        pairs = self.cluster_pairs(data, ego_poses, nonground)
        clock.mark("end")
        clock.finish()
        return data, pairs

    def __getitem__(self, idx: int):
        return self._prepare(self.load_raw(self.seq_paths[idx]))
