"""The sharded step: dp over frame pairs, cp over cluster pairs.

Port of ``icpflow_tpu/parallel/shard.py``. A batch of frame pairs is split
over the ``dp`` axis of a (dp, cp) mesh; inside each frame pair the
matcher's cluster-pair buckets are split over ``cp``
(``match/matcher.py``); per-point EPE sums are added over dp into one
metric vector, the distributed form of the reference's AverageMeter
(`utils_eval.py:82-135`).

JAX's ``shard_map`` becomes one process a rank. Every rank calls the step
with the whole batch (the CLI broadcasts it from rank 0 with
:func:`broadcast_batch`), runs its dp slice of the pairs one after another
(JAX's ``lax.map``), gathers flow and transforms over dp so that every rank
returns the whole batch, and adds the metric sums over dp only: the cp
ranks of a pair already hold the same results. Each pair carries its own
ego ``pose`` and ``translation_frame``, so one batch can mix frame gaps.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..flow import flow_with_identity_override
from ..match.matcher import match_frame_pair
from ..metrics import compute_epe_sums
from ..ops import geometry as geo
from ..ops.segments import extract_segments
from .mesh import Axis, make_mesh


def _batch_layout(b: int, n: int):
    """(shape, dtype) of the step's nine inputs for ``b`` pairs of
    ``n``-slot clouds, in the order of ``ShardedStep.__call__``."""
    f32, cloud, mask, label = torch.float32, (b, n, 3), (b, n), (b, n)
    return [(cloud, f32), (mask, torch.bool), (label, torch.int32),
            (cloud, f32), (mask, torch.bool), (label, torch.int32),
            (cloud, f32), ((b, 4, 4), f32), ((b,), f32)]


def _frame_pair_step(pts_src, valid_src, labels_src, pts_dst, valid_dst,
                     labels_dst, gt_flow, pose, translation_frame: float,
                     cfg: PipelineConfig, cp_group=None):
    """One frame pair: segments of both frames, the matcher (over
    ``cp_group`` when given), flow on the raw source and its metric sums.
    Returns (flow (N,3), transforms (L,4,4), sums (6,), overflow ())."""
    seg_src = extract_segments(pts_src, labels_src, valid_src,
                               num_labels=cfg.num_clusters,
                               max_points=cfg.max_points)
    seg_dst = extract_segments(pts_dst, labels_dst, valid_dst,
                               num_labels=cfg.num_clusters,
                               max_points=cfg.max_points)
    result = match_frame_pair(seg_src, seg_dst, translation_frame, cfg,
                              cp_group=cp_group)
    # flow is defined on the RAW source points, flow = (T_cluster o pose)
    # x - x (`utils_flow.py:36-48`); the step receives the ego-aligned
    # cloud (pts_src = pose . raw) and recovers raw on the device
    raw_src = geo.transform_points_batch(
        pts_src[None], geo.invert_rigid(pose[None]))[0]
    flow = flow_with_identity_override(
        raw_src, labels_src, result.transforms, pose, seg_src.pidx,
        result.identity_pt)
    sums = compute_epe_sums(flow, gt_flow, valid_src)
    return flow, result.transforms, sums, result.overflow


class ShardedStep:
    """``step(pts_src, valid_src, labels_src, pts_dst, valid_dst,
    labels_dst, gt_flow, poses, translation_frames) -> (flow (B,N,3),
    transforms (B,L,4,4), metric_sums (6,))`` on every rank of the mesh.

    ``poses`` is (B,4,4) ego poses, ``translation_frames`` (B,) per-pair
    search radii; B must divide by the dp width, and the pair buckets
    (``num_clusters``, ``max_pairs``) by the cp width. metric_sums = [num,
    epe, accs, accr, outlier, routlier] over the whole batch (merge with
    ``AverageMeter.merge_sums``). After a call, ``overflow`` (B,) holds each
    pair's matcher overflow (per-slice drops summed over cp), and
    ``counts`` / ``nbytes`` the collectives it issued: calls and output
    bytes by op.
    """

    def __init__(self, mesh, cfg: PipelineConfig):
        self.cfg = cfg
        self.counts: collections.Counter = collections.Counter()
        self.nbytes: collections.Counter = collections.Counter()
        self.dp = Axis(mesh, "dp", self.counts, self.nbytes)
        cp = Axis(mesh, "cp", self.counts, self.nbytes)
        self.cp = cp if cp.size > 1 else None
        self.overflow = None

    def __call__(self, pts_src, valid_src, labels_src, pts_dst, valid_dst,
                 labels_dst, gt_flow, poses, translation_frames):
        b = pts_src.shape[0]
        per = b // self.dp.size
        if per * self.dp.size != b:
            raise ValueError(f"batch {b} does not split over "
                             f"{self.dp.size} dp ranks")
        self.counts.clear()
        self.nbytes.clear()
        lo = self.dp.rank * per
        tfs = translation_frames.tolist()
        outs = [_frame_pair_step(
            pts_src[i], valid_src[i], labels_src[i], pts_dst[i],
            valid_dst[i], labels_dst[i], gt_flow[i], poses[i], tfs[i],
            self.cfg, self.cp) for i in range(lo, lo + per)]
        flow, transforms, sums, overflow = (
            torch.stack([o[k].to(pts_src.device) for o in outs])
            for k in range(4))
        sums = torch.sum(sums, dim=0)
        if self.dp.size > 1:
            flow = self.dp.all_gather(flow)
            transforms = self.dp.all_gather(transforms)
            overflow = self.dp.all_gather(overflow)
            sums = self.dp.all_reduce(sums, "sum")
        self.overflow = overflow
        return flow, transforms, sums


def make_sharded_step(mesh, cfg: PipelineConfig) -> ShardedStep:
    """The step over a (dp, cp) mesh (``parallel.mesh.make_mesh``)."""
    return ShardedStep(mesh, cfg)


def broadcast_batch(batch, device):
    """Rank 0's batch on every rank.

    On rank 0 ``batch`` is the step's nine inputs as numpy arrays, or None
    to tell the other ranks that no batch follows; the other ranks pass
    None. Returns the nine tensors on ``device``, or None after a stop."""
    dev = torch.device(device)
    header = torch.zeros(2, dtype=torch.int64, device=dev)
    if batch is not None:
        header[0], header[1] = batch[0].shape[:2]
    dist.broadcast(header, 0)
    b, n = header.tolist()
    if b == 0:
        return None
    out = []
    for k, (shape, dtype) in enumerate(_batch_layout(b, n)):
        if batch is None:
            t = torch.empty(shape, dtype=dtype, device=dev)
        else:
            t = torch.as_tensor(np.ascontiguousarray(batch[k]),
                                dtype=dtype).to(dev)
        dist.broadcast(t, 0)
        out.append(t)
    return out


def rank_stats() -> dict:
    """This rank's NN kernel launches (in all and by (kernel, B, N, M)) and
    plain NN calls since its counters were last reset, and whether TF32 is
    on for matmuls or convolutions (the package turns it off)."""
    from ..ops import knn
    from ..ops.cuda import nn_kernel
    return dict(rank=dist.get_rank(), nn_launches=nn_kernel.launches,
                shape_launches=dict(nn_kernel.shape_launches),
                plain_calls=knn.plain_calls,
                tf32=(torch.backends.cuda.matmul.allow_tf32
                      or torch.backends.cudnn.allow_tf32))


def serve_pairs(cfg: PipelineConfig, n_dp: int, n_cp: int, device):
    """The loop of every rank but 0: run the step on each batch that rank 0
    broadcasts until it stops them, then hand back :func:`rank_stats`."""
    step = make_sharded_step(make_mesh(n_dp, n_cp, device), cfg)
    while (batch := broadcast_batch(None, device)) is not None:
        step(*batch)
    dist.gather_object(rank_stats(), None, dst=0)


def stop_ranks(device) -> list:
    """Rank 0: stop the ranks in :func:`serve_pairs`. Returns every rank's
    :func:`rank_stats`, in rank order."""
    broadcast_batch(None, device)
    out = [None] * dist.get_world_size()
    dist.gather_object(rank_stats(), out, dst=0)
    return out
