"""StreamingEngine: online per-frame scene flow for serving.

Port of ``icpflow_tpu/models/streaming.py``. Frames are processed
incrementally:

  new scan -> (optional) ego odometry against the running map ->
  ground removal -> joint clustering with the previous kept frame ->
  two-stage matching -> per-point flow of the new frame.

The previous frame's buffers stay on the engine's device between frames,
so each frame costs the device pipeline plus one host transfer of the new
scan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, StageClock
from ..ops.ego import EgoOdometry
from ..ops.ground import segment_ground
from .icp_flow import SceneFlowEngine


class StreamOutput(NamedTuple):
    flow: np.ndarray          # (n, 3) flow of the new frame vs previous
    pose: np.ndarray          # (4, 4) ego pose of the new frame (world)
    pairs: np.ndarray         # (K, 10) matched pairs table
    labels: np.ndarray        # (n,) cluster labels of the new frame


class StreamingEngine:
    """Online scene flow over a scan stream on one torch device.

    Runs on the GPU unless the caller passes another ``device``; a CUDA
    device on a machine without a usable GPU raises, as ``SceneFlowEngine``
    does.
    """

    def __init__(self, cfg: PipelineConfig, estimate_ego: bool = True,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.engine = SceneFlowEngine(cfg, device=device)
        self.device = self.engine.device
        self.odo: Optional[EgoOdometry] = (
            EgoOdometry(cfg, self.device) if estimate_ego else None)
        self._prev = None          # (pts, valid, non-ground) on device

    def reset(self):
        self._prev = None
        if self.odo is not None:
            self.odo = EgoOdometry(self.cfg, self.device)

    def process(self, scan: np.ndarray, pose: Optional[np.ndarray] = None,
                timings: Optional[dict] = None) -> Optional[StreamOutput]:
        """Feed one (n, 3) scan in sensor coordinates.

        ``pose`` overrides ego estimation (world <- sensor). Returns None for
        the very first frame (no pair yet). ``timings``, when given,
        receives the milliseconds of the ``ego`` and ``ground`` stages and,
        from the second frame on, ``cluster``, ``track`` and ``flow``.
        """
        cfg = self.cfg
        eng = self.engine
        clock = StageClock(timings, self.device)
        scan = np.asarray(scan, np.float32)[:, :3]

        clock.mark("ego")
        if pose is None and self.odo is not None:
            pose = self.odo.register_frame(scan)
        if pose is None:
            pose = np.eye(4, dtype=np.float32)
        pose = np.asarray(pose, np.float32)

        clock.mark("ground")
        world = scan @ pose[:3, :3].T + pose[:3, 3]
        p, v = eng.pad_cloud(world)
        pts = eng._tensor(p, torch.float32)
        valid = eng._tensor(v, torch.bool)
        ng = segment_ground(pts, valid, range_z=cfg.range_z,
                            ground_slack=cfg.ground_slack)

        prev = self._prev
        self._prev = (pts, valid, ng)
        if prev is None:
            clock.mark("end")
            clock.finish()
            return None

        pts_prev, valid_prev, ng_prev = prev
        clock.mark("cluster")
        # joint clustering: previous frame is "dst", new frame is "src"
        lab_dst, lab_src = eng.cluster_joint(pts_prev, valid_prev & ng_prev,
                                             pts, valid & ng)
        clock.mark("track")
        out = eng.track_pair(pts, valid, lab_src, pts_prev, valid_prev,
                             lab_dst, cfg.translation_frame(1))
        clock.mark("flow")
        # flow in world coordinates of the new frame vs the previous one
        flow = eng.flow(pts, lab_src, out.result.transforms,
                        np.eye(4, dtype=np.float32),
                        seg_pidx=out.seg_src.pidx,
                        identity_pt=out.result.identity_pt)
        clock.mark("end")
        clock.finish()
        return StreamOutput(flow=flow.cpu().numpy()[:len(scan)], pose=pose,
                            pairs=eng.pairs_array(out.result),
                            labels=lab_src.cpu().numpy()[:len(scan)])
