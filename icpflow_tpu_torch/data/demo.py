"""Demo fixture loader: a single AV2 frame pair with GT flow.

Format spec from `demo.py:37-71` (dataloader_minimal): npz with keys
``pc1/pc2`` (N,3), ``pc1_flows_valid_idx/pc2_flows_valid_idx`` (index arrays),
``gt_flow_0_1`` (N,3), ``pc1_classes/pc2_classes``. The stored clouds are
already ego-compensated and ground-removed. A copy of
``icpflow_tpu/data/demo.py`` (which cannot be imported without JAX).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def load_demo_npz(path: str, subsample: Optional[int] = None,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """Load the demo frame pair; optionally subsample each cloud."""
    data = np.load(path)
    pc1 = np.asarray(data["pc1"], np.float32)
    pc2 = np.asarray(data["pc2"], np.float32)
    v1 = np.asarray(data["pc1_flows_valid_idx"])
    v2 = np.asarray(data["pc2_flows_valid_idx"])
    flow = np.asarray(data["gt_flow_0_1"], np.float32)
    cls1 = np.asarray(data["pc1_classes"])

    src = pc1[v1]
    dst = pc2[v2]
    gt = flow[v1]
    cls = cls1[v1]
    if subsample is not None and len(src) > subsample:
        rng = np.random.default_rng(seed)
        i1 = rng.choice(len(src), subsample, replace=False)
        i2 = rng.choice(len(dst), subsample, replace=False)
        src, gt, cls = src[i1], gt[i1], cls[i1]
        dst = dst[i2]
    return {
        "point_src": src,
        "point_dst": dst,
        "scene_flow": gt,
        "classes_src": cls,
        "data_path": path,
    }
