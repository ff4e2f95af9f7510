# Frozen copy of the port's plain path, icpflow_tpu_torch/ops/segments.py, for the
# benchmark's reference. It imports nothing of the program; leave it as
# it is when the program changes: it is the yardstick.
"""Fixed-shape segment batches (port of ``icpflow_tpu/ops/segments.py``).

Given a padded cloud and per-point labels, gather each cluster's points
into a ``(L, P)`` masked batch with one stable sort and one gather.

Label convention: >= 0 cluster id in [0, L); -1 valid point outside a
kept cluster; <= -2 ground.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

GROUND_LABEL = -(10 ** 8)


class SegmentBatch(NamedTuple):
    """Masked fixed-shape segments of one frame.

    xyz (L,P,3) zeros where invalid; mask (L,P); count (L,) true cluster
    sizes; mean (L,3); extent (L,3) sorted bbox sides; pidx (L,P) int32
    raw-cloud index of each slot (0 where invalid).
    """
    xyz: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    mean: torch.Tensor
    extent: torch.Tensor
    pidx: torch.Tensor


def extract_segments(points: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, *, num_labels: int,
                     max_points: int) -> SegmentBatch:
    """Gather each label's points into a (num_labels, max_points) batch.

    Clusters larger than ``max_points`` keep an evenly strided subsample
    (slot p takes the cluster's point p * count // P).
    """
    n = points.shape[0]
    L, P = num_labels, max_points
    dev = points.device
    lab = torch.where(valid, labels.long(), torch.full_like(labels.long(),
                                                            GROUND_LABEL))
    key = torch.where(lab >= 0, lab, torch.full_like(lab, L))
    counts = torch.bincount(key, minlength=L + 1)[:L]
    order = torch.sort(key, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts

    p_iota = torch.arange(P, device=dev)
    cnt = counts[:, None]
    sel = torch.where(cnt > P, (p_iota[None, :] * cnt) // P, p_iota[None, :])
    mask = p_iota[None, :] < torch.clamp(cnt, max=P)
    gidx = torch.clamp(starts[:, None] + sel, 0, n - 1)
    pidx = order[gidx]
    xyz = points[pidx].float() * mask[:, :, None]

    wm = mask.float()
    mean = torch.sum(xyz * wm[:, :, None], 1) / torch.clamp(
        torch.sum(wm, 1), min=1e-9)[:, None]
    m3 = mask[:, :, None]
    hi = torch.amax(torch.where(m3, xyz, torch.full_like(xyz, -1e9)), dim=1)
    lo = torch.amin(torch.where(m3, xyz, torch.full_like(xyz, 1e9)), dim=1)
    extent = torch.sort(torch.clamp(hi - lo, min=0.0), dim=1).values
    pidx = torch.where(mask, pidx, torch.zeros_like(pidx)).to(torch.int32)
    return SegmentBatch(xyz=xyz, mask=mask, count=counts.to(torch.int32),
                        mean=mean, extent=extent, pidx=pidx)
