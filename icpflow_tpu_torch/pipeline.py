"""High-level frame-pair pipeline (port of ``icpflow_tpu/pipeline.py``).

Inputs are two ego-aligned, ground-removed host clouds; output is the
per-point flow of the source cloud plus the match tables, on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .models.icp_flow import SceneFlowEngine
from .trace import StageClock


class FramePairResult(NamedTuple):
    flow: np.ndarray          # (n_src, 3)
    pairs: np.ndarray         # (K, 10) reference-layout pairs table
    transforms: np.ndarray    # (L, 4, 4) per-label transforms
    labels_src: np.ndarray    # (n_src,)
    labels_dst: np.ndarray    # (n_dst,)
    overflow: int


def run_frame_pair(engine: SceneFlowEngine, point_src: np.ndarray,
                   point_dst: np.ndarray, *,
                   translation_frame: Optional[float] = None,
                   pose: Optional[np.ndarray] = None,
                   timings: Optional[dict] = None) -> FramePairResult:
    """Estimate flow src->dst for one ego-aligned frame pair (ICP-Flow
    `demo.py:205-226`): joint clustering, track, flow with the given ego
    pose (identity for pre-compensated input). ``timings`` receives the
    per-stage milliseconds of ``SceneFlowEngine.run_pair`` and traces the
    whole call as ``icpflow.pair`` (``icpflow_tpu_torch.trace``)."""
    cfg = engine.cfg
    if translation_frame is None:
        translation_frame = cfg.speed * 2.0
    if pose is None:
        pose = np.eye(4, dtype=np.float32)
    with StageClock(timings, engine.device, "pair"):
        p_src, v_src = engine.pad_cloud(point_src)
        p_dst, v_dst = engine.pad_cloud(point_dst)
        fused = engine.run_pair(p_src, v_src, p_dst, v_dst,
                                translation_frame, pose, timings=timings)
        res = fused.track.result
        return FramePairResult(
            flow=fused.flow.cpu().numpy()[:len(point_src)],
            pairs=engine.pairs_array(res),
            transforms=res.transforms.cpu().numpy(),
            labels_src=fused.lab_src.cpu().numpy()[:len(point_src)],
            labels_dst=fused.lab_dst.cpu().numpy()[:len(point_dst)],
            overflow=int(res.overflow),
        )
