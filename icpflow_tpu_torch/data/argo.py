"""Argoverse-2 dataset via ZeroFlow npz exports.

Re-implements `dataset_argo.py:15-142`: per-sample npz (pc1/pc2, valid idx,
gt_flow_0_1, per-point classes, ground masks); builds a 2-frame sample with
identity ego poses; derives sd labels (||flow|| > 0.05 m at 10 Hz) and fb
labels from the 30-class AV2 taxonomy (`dataset_argo.py:66-71,145-217`).
Port of ``icpflow_tpu/data/argo.py``: the host side is the same numpy; the
joint clustering runs on ``device`` through ``DatasetPCA.cluster_pairs``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, resolve_device
from .loading import PrefetchIterMixin

CATEGORY_ID_TO_NAME = {
    -1: "BACKGROUND", 0: "ANIMAL", 1: "ARTICULATED_BUS", 2: "BICYCLE",
    3: "BICYCLIST", 4: "BOLLARD", 5: "BOX_TRUCK", 6: "BUS",
    7: "CONSTRUCTION_BARREL", 8: "CONSTRUCTION_CONE", 9: "DOG",
    10: "LARGE_VEHICLE", 11: "MESSAGE_BOARD_TRAILER",
    12: "MOBILE_PEDESTRIAN_CROSSING_SIGN", 13: "MOTORCYCLE",
    14: "MOTORCYCLIST", 15: "OFFICIAL_SIGNALER", 16: "PEDESTRIAN",
    17: "RAILED_VEHICLE", 18: "REGULAR_VEHICLE", 19: "SCHOOL_BUS",
    20: "SIGN", 21: "STOP_SIGN", 22: "STROLLER", 23: "TRAFFIC_LIGHT_TRAILER",
    24: "TRUCK", 25: "TRUCK_CAB", 26: "VEHICULAR_TRAILER", 27: "WHEELCHAIR",
    28: "WHEELED_DEVICE", 29: "WHEELED_RIDER",
}
CATEGORY_NAME_TO_IDX = {
    v: i for i, (_, v) in enumerate(sorted(CATEGORY_ID_TO_NAME.items()))
}
BACKGROUND_CATEGORIES = [
    "BOLLARD", "CONSTRUCTION_BARREL", "CONSTRUCTION_CONE",
    "MOBILE_PEDESTRIAN_CROSSING_SIGN", "SIGN", "STOP_SIGN",
]


class DatasetArgo(PrefetchIterMixin):
    """AV2 ZeroFlow-export dataset; identity ego, clustering via engine.
    Clusters on the GPU unless the caller passes another ``device``; a CUDA
    device on a machine without a usable GPU raises ``RuntimeError``."""

    def __init__(self, cfg: PipelineConfig, root: str, split: str,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timings = None      # see DatasetPCA
        self.seq_paths: List[str] = sorted(glob.glob(
            os.path.join(root, split + "_zero_flow", "*", "*.npz")))
        if not self.seq_paths:
            self.seq_paths = sorted(glob.glob(os.path.join(root, "*.npz")))
        self.background_idxes = [
            CATEGORY_NAME_TO_IDX[c] for c in BACKGROUND_CATEGORIES]

    def __len__(self):
        return len(self.seq_paths)

    def load_raw(self, path: str) -> Dict[str, np.ndarray]:
        from .native_loader import load_npz
        return self._raw_from_dict(load_npz(path), path)

    def _raw_from_dict(self, d, path: str) -> Dict[str, np.ndarray]:
        pcl0 = d["pc1"][d["pc1_flows_valid_idx"]]
        pcl1 = d["pc2"][d["pc2_flows_valid_idx"]]
        flow01 = d["gt_flow_0_1"][d["pc1_flows_valid_idx"]]
        cls0 = d["pc1_classes"][d["pc1_flows_valid_idx"]]

        sd = np.linalg.norm(flow01, axis=-1) > (0.5 * 0.1)   # 10 Hz dynamic
        fb = np.ones(len(pcl0), bool)
        for idx in self.background_idxes:
            fb[cls0 == idx] = False
        fb[cls0 == -1] = False

        raw = np.concatenate([pcl1, pcl0]).astype(np.float32)
        ti = np.concatenate([np.zeros(len(pcl1)), np.ones(len(pcl0))])
        return {
            "raw_points": raw,
            "time_indice": ti,
            "sd_labels": np.concatenate([np.zeros(len(pcl1)), sd]),
            "fb_labels": np.concatenate([np.zeros(len(pcl1)), fb]),
            "ego_motion_gt": np.stack([np.eye(4), np.eye(4)]).astype(
                np.float32),
            "scene_flow": np.concatenate(
                [np.zeros((len(pcl1), 3)), flow01]).astype(np.float32),
            "data_path": path,
        }

    def _prepare(self, data, clock=None):
        from ..device import StageClock
        from .pca import DatasetPCA
        clock = clock or StageClock(self.timings, self.device,
                                    "offline.sample")
        data["ego_poses"] = data["ego_motion_gt"]
        # AV2 exports are already ground-filtered; all points non-ground
        # (dataset_argo.py:140)
        nonground = np.ones(len(data["raw_points"]), bool)
        clock.mark("cluster")
        pairs = DatasetPCA.cluster_pairs(self, data, data["ego_poses"],
                                         nonground)
        clock.mark("end")
        clock.finish()
        return data, pairs

    def __getitem__(self, idx: int):
        return self._prepare(self.load_raw(self.seq_paths[idx]))
