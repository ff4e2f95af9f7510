"""icpflow_tpu_torch: the ICP-Flow scene-flow pipeline in PyTorch + CUDA.

A port of ``icpflow_tpu`` (JAX) that runs on one NVIDIA Hopper GPU, or on
the CPU through plain PyTorch versions of its kernels. Learning-free scene
flow: joint density clustering of two ego-aligned frames, histogram-
initialised batched ICP over cluster pairs, and rigid per-cluster flow;
``StreamingEngine`` runs it online over a scan stream with KISS-ICP-style
ego odometry and CZM ground removal.

All distance and pose math is fp32. TF32 would keep about three decimal
digits, which metre-scale coordinates under a 0.1 m gate do not survive,
so importing the package turns it off for matmuls and convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (ARGO, DEMO, NUSCENES, PRESETS, WAYMO,  # noqa: E402
                     PipelineConfig, config_from_dict)
from .models.icp_flow import SceneFlowEngine  # noqa: E402
from .models.streaming import StreamingEngine  # noqa: E402
from .ops.ego import EgoOdometry  # noqa: E402
from .ops.ground import segment_ground  # noqa: E402
from .pipeline import run_frame_pair  # noqa: E402

__all__ = ["PipelineConfig", "PRESETS", "WAYMO", "NUSCENES", "ARGO", "DEMO",
           "config_from_dict", "SceneFlowEngine", "run_frame_pair",
           "StreamingEngine", "EgoOdometry", "segment_ground"]
