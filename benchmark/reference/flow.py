# Frozen copy of the port's plain path, icpflow_tpu_torch/flow.py, for the
# benchmark's reference. It imports nothing of the program; leave it as
# it is when the program changes: it is the yardstick.
"""Flow assembly from per-cluster transforms (port of
``icpflow_tpu/flow.py``; ICP-Flow `utils_flow.py:23-69`).

Each source point takes its cluster's transform (identity when unmatched,
unclustered or ground) composed with the ego pose; flow = (T o pose) x - x.
All products are full fp32 (TF32 is off): reduced-precision pose math gives
every static point a per-gap flow error.
"""

from __future__ import annotations

import torch


def flow_from_transforms(points: torch.Tensor, labels: torch.Tensor,
                         transforms: torch.Tensor,
                         pose: torch.Tensor) -> torch.Tensor:
    """Per-point flow. points (N,3); labels (N,) (negative -> identity);
    transforms (L,4,4); pose (4,4). Returns (N,3)."""
    L = transforms.shape[0]
    eye = torch.eye(4, dtype=transforms.dtype, device=transforms.device)[None]
    table = torch.cat([transforms, eye], dim=0)                  # (L+1,4,4)
    lab = labels.long()
    idx = torch.where((lab >= 0) & (lab < L), lab, torch.full_like(lab, L))
    T_full = torch.einsum("nij,jk->nik", table[idx], pose)
    moved = torch.einsum("nij,nj->ni", T_full[:, :3, :3], points) \
        + T_full[:, :3, 3]
    return moved - points


def flow_with_identity_override(points: torch.Tensor, labels: torch.Tensor,
                                transforms: torch.Tensor, pose: torch.Tensor,
                                seg_pidx: torch.Tensor,
                                identity_pt: torch.Tensor) -> torch.Tensor:
    """Per-point flow with the matcher's ego-only overrides applied:
    ``identity_pt`` (L,P) flags points (raw index ``seg_pidx`` (L,P)) whose
    flow reverts to the ego-pose-only component."""
    flow = flow_from_transforms(points, labels, transforms, pose)
    ego_moved = points @ pose[:3, :3].T + pose[:3, 3]
    flag = identity_pt.reshape(-1)
    tgt = seg_pidx.reshape(-1).long()[flag]
    flow[tgt] = (ego_moved - points)[tgt]
    return flow
