"""Ego-motion estimation: KISS-ICP-style odometry.

Port of ``icpflow_tpu/ops/ego.py``: range crop -> double voxel downsample
(0.5x map voxel for the local map insert, 1.5x for the registration source)
-> constant-velocity initial guess -> robust point-to-map ICP against a
fixed-capacity voxel-deduplicated map buffer -> adaptive threshold update.
See that module for the mapping to the reference (and why deskewing is
omitted).

The reference's ``lax.while_loop``s are host loops here, with one host read
of the pose update per iteration and the same termination rule. The map
and its validity stay on the device between frames; the poses, the
prediction and the adaptive threshold are host numpy, as in the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import trace as _trace
from ..config import PipelineConfig
from ..device import DEFAULT_DEVICE, resolve_device
from . import geometry as geo
from . import knn as _knn

_NO_VOXEL = 2 ** 30            # id of an invalid point


def voxel_downsample_mask(xyz: torch.Tensor, valid: torch.Tensor, *,
                          voxel: float, per_voxel: int = 1) -> torch.Tensor:
    """Mark the first ``per_voxel`` points of each occupied voxel.

    ``per_voxel=1`` is a plain dedup (registration-source downsample); the
    local map keeps up to ``ego_map_per_voxel`` points per voxel, as
    kiss-icp's VoxelHashMap does. The sort is stable, so earlier buffer
    positions win the per-voxel slots (the map update relies on this: old
    map points precede the new scan). Voxel ids are int32 with the
    reference's wrap-around arithmetic; the ranks within a voxel come from
    a running maximum of the run starts.
    """
    n = xyz.shape[0]
    valid = valid.bool()
    cell = torch.floor(geo.scale_as_xla(xyz.float(), voxel)).to(torch.int32)
    big = torch.full_like(cell, 2 ** 20)
    cmin = torch.amin(torch.where(valid[:, None], cell, big), dim=0)
    cmax = torch.amax(torch.where(valid[:, None], cell, -big), dim=0)
    span = torch.clamp(cmax - cmin + 1, min=1)
    cc = cell - cmin
    ids = (cc[:, 0] * span[1] + cc[:, 1]) * span[2] + cc[:, 2]
    ids = torch.where(valid, ids, torch.full_like(ids, _NO_VOXEL))
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    first = torch.ones((n,), dtype=torch.bool, device=xyz.device)
    first[1:] = ids_s[1:] != ids_s[:-1]
    if per_voxel == 1:
        keep_sorted = first & (ids_s < _NO_VOXEL)
    else:
        idxs = torch.arange(n, dtype=torch.int32, device=xyz.device)
        run_start = torch.cummax(
            torch.where(first, idxs, torch.zeros_like(idxs)), dim=0).values
        keep_sorted = ((idxs - run_start) < per_voxel) & (ids_s < _NO_VOXEL)
    keep = torch.zeros((n,), dtype=torch.bool, device=xyz.device)
    keep[order] = keep_sorted
    return keep & valid


@_trace.spanned("icpflow.ego.register")
def register_frame_icp(source: torch.Tensor, source_valid: torch.Tensor,
                       map_pts: torch.Tensor, map_valid: torch.Tensor,
                       initial_guess: torch.Tensor, max_dist: float,
                       kernel: float, *, iters: int = 500,
                       tile: int = 2048) -> torch.Tensor:
    """Robust point-to-map ICP. Returns the refined (4,4) pose.

    Geman-McClure weights w = (k^2 / (k^2 + d^2))^2 with correspondences
    gated at ``max_dist``, iterated while the pose update exceeds 1e-4 and
    fewer than ``iters`` iterations ran (kiss-icp Registration.cpp). A
    translation-only phase (rotation frozen at the initial guess) runs to
    its fixpoint, the full-DOF phase continues from there, and the pose
    with the lower saturated robust cost (0.1 m kernel) is returned, the
    full-DOF one on a tie. The NN sweep is ``masked_nn(..., exact=True)``
    over the valid source points only: the others carry weight 0 in every
    step and in the score, whatever their neighbour.
    """
    f32 = torch.float32
    dev = source.device
    source = source.to(f32)
    source_valid = source_valid.bool()
    map_pts = map_pts.to(f32)
    map_valid = map_valid.bool()
    initial_guess = initial_guess.to(f32)
    max_dist = torch.tensor(max_dist, dtype=f32, device=dev)
    k2 = torch.tensor(kernel, dtype=f32, device=dev) ** 2

    def nn_dist(pose):
        moved = geo.transform_points_batch(source[None], pose[None])
        idx, dist = _knn.masked_nn(moved, map_pts[None], map_valid[None],
                                   tile=tile, exact=True,
                                   src_mask=source_valid[None])
        return idx[0], dist[0]

    R0 = initial_guess[:3, :3]
    rs = source @ R0.T

    def step(pose, full_dof):
        idx, dist = nn_dist(pose)
        nn = map_pts[idx.long()]
        w_gm = (k2 / (k2 + dist ** 2)) ** 2
        w = torch.where((dist <= max_dist) & source_valid, w_gm,
                        torch.zeros_like(w_gm))
        if full_dof:
            R, t = geo.kabsch(source[None], nn[None], w[None])
            new_pose = geo.rt_to_mat(R, t)[0]
        else:
            # rotation frozen: weighted-centroid translation update of
            # R0 @ src + t ~= nn  =>  t = mean_w(nn - R0 @ src)
            denom = torch.clamp(torch.sum(w), min=1e-9)
            t = torch.sum((nn - rs) * w[:, None], dim=0) / denom
            new_pose = pose.clone()
            new_pose[:3, :3] = R0
            new_pose[:3, 3] = t
        delta = (torch.linalg.vector_norm(new_pose[:3, 3] - pose[:3, 3])
                 + torch.linalg.vector_norm(new_pose[:3, :3] - pose[:3, :3]))
        return new_pose, delta

    def converge(pose, full_dof):
        it = 0
        while it < iters:
            pose, delta = step(pose, full_dof)
            it += 1
            _trace.count("ego_iters")
            if not bool(delta > 1e-4):                 # one host read
                break
        return pose

    def score(pose):
        # saturated robust cost, fixed 0.1 m kernel: movers saturate and
        # cancel, static structure at the noise floor decides
        d2 = nn_dist(pose)[1] ** 2
        rho = d2 / (0.01 + d2)
        return torch.sum(torch.where(source_valid, rho, torch.zeros_like(rho)))

    pose_t = converge(initial_guess, False)
    pose_f = converge(pose_t, True)
    return torch.where(score(pose_f) <= score(pose_t), pose_f, pose_t)


class EgoOdometry:
    """Sequential odometry over frames (host loop, device compute).

    ``register_frame(frame) -> pose`` appends to ``poses`` (host float32
    (4,4) arrays). The map (``_map`` (cap,3) f32, ``_map_valid`` (cap,)
    bool) lives on ``device``: the GPU unless the caller names another; a
    CUDA device on a machine without a usable GPU raises ``RuntimeError``.
    """

    def __init__(self, cfg: PipelineConfig, device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.poses: List[np.ndarray] = []
        cap = cfg.ego_map_capacity
        self._map = torch.zeros((cap, 3), dtype=torch.float32,
                                device=self.device)
        self._map_valid = torch.zeros((cap,), dtype=torch.bool,
                                      device=self.device)
        self._deviations: List[float] = []

    @classmethod
    def from_arrays(cls, cfg: PipelineConfig, poses, map_pts, map_valid,
                    deviations, device=DEFAULT_DEVICE) -> "EgoOdometry":
        """An odometry that continues a sequence from host state, e.g. the
        JAX package's ``EgoOdometry`` (``poses``, ``_map``, ``_map_valid``,
        ``_deviations``) as numpy."""
        odo = cls(cfg, device)
        odo.poses = [np.asarray(p, np.float32) for p in poses]
        odo._map = torch.tensor(np.asarray(map_pts), dtype=torch.float32,
                                device=odo.device)
        odo._map_valid = torch.tensor(np.asarray(map_valid), dtype=torch.bool,
                                      device=odo.device)
        odo._deviations = [float(d) for d in deviations]
        return odo

    # -- adaptive threshold (kiss-icp threshold.py semantics) --------------
    def _sigma(self) -> float:
        cfg = self.cfg
        if not self._has_moved() or not self._deviations:
            return cfg.ego_initial_threshold
        dev = np.asarray(self._deviations)
        dev = dev[dev > cfg.ego_min_motion_th]
        if len(dev) == 0:
            return cfg.ego_initial_threshold
        return float(np.sqrt(np.mean(dev ** 2)))

    def _has_moved(self) -> bool:
        if len(self.poses) < 1:
            return False
        motion = np.linalg.norm(
            (np.linalg.inv(self.poses[0]) @ self.poses[-1])[:3, 3])
        return motion > 5 * self.cfg.ego_min_motion_th

    def _prediction(self) -> np.ndarray:
        if len(self.poses) < 2:
            return np.eye(4, dtype=np.float32)
        return np.linalg.inv(self.poses[-2]) @ self.poses[-1]

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(device=self.device,
                                                 dtype=dtype)

    def register_frame(self, frame: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        r = np.linalg.norm(frame[:, :3], axis=1)
        frame = frame[(r > cfg.ego_min_range) & (r < cfg.ego_max_range), :3]
        frame = frame.astype(np.float32)

        cap = cfg.max_points_scene
        n = min(len(frame), cap)
        buf = torch.zeros((cap, 3), dtype=torch.float32, device=self.device)
        buf[:n] = self._tensor(frame[:n])
        valid = torch.arange(cap, device=self.device) < n

        keep_map = voxel_downsample_mask(buf, valid,
                                         voxel=cfg.ego_voxel_size * 0.5)
        keep_src = voxel_downsample_mask(buf, keep_map,
                                         voxel=cfg.ego_voxel_size * 1.5)

        # registration source: the 1.5x-voxel downsample compacted into its
        # own small bucket (kiss-icp registers exactly this cloud)
        src_pts = buf[keep_src]
        scap = int(cfg.ego_src_capacity)
        ns = min(len(src_pts), scap)
        sbuf = torch.zeros((scap, 3), dtype=torch.float32, device=self.device)
        sbuf[:ns] = src_pts[:ns]
        svalid = torch.arange(scap, device=self.device) < ns

        if not self.poses:
            pose = np.eye(4, dtype=np.float32)
        else:
            sigma = self._sigma()
            initial = (self.poses[-1] @ self._prediction()).astype(np.float32)
            pose_t = register_frame_icp(
                sbuf, svalid, self._map, self._map_valid,
                self._tensor(initial), 3.0 * sigma, sigma / 3.0,
                iters=cfg.ego_max_iters)
            for s2 in cfg.ego_refine_sigmas:
                # graduated refinement: a decreasing sigma schedule first
                # crushes mover weights, then polishes translation on near
                # surfaces; each pass starts from the previous pose
                pose_t = register_frame_icp(
                    sbuf, svalid, self._map, self._map_valid, pose_t,
                    3.0 * s2, s2 / 3.0, iters=cfg.ego_max_iters)
            pose = pose_t.cpu().numpy()
            # model deviation for the adaptive threshold: translation plus
            # the rotation-induced displacement at max range (kiss-icp
            # ComputeModelError)
            dev = np.linalg.inv(self.poses[-1] @ self._prediction()) @ pose
            theta = np.arccos(np.clip((np.trace(dev[:3, :3]) - 1) / 2,
                                      -1.0, 1.0))
            model_err = (2.0 * cfg.ego_max_range * np.sin(theta / 2.0)
                         + np.linalg.norm(dev[:3, 3]))
            self._deviations.append(float(model_err))

        # map update: insert the downsampled frame in world coordinates,
        # voxel-dedup with EXISTING map points winning occupied voxels, then
        # truncate to capacity; prune map points beyond max_range of the
        # current pose. Order matters: old first, dedup, then truncate.
        pose_d = self._tensor(pose)
        world = buf[keep_map] @ pose_d[:3, :3].T + pose_d[:3, 3]
        old = self._map[self._map_valid]
        if len(old):
            old = old[torch.linalg.vector_norm(old - pose_d[:3, 3], dim=1)
                      <= cfg.ego_max_range]
        capn = cfg.ego_map_capacity
        allpts = torch.cat([old, world])          # old FIRST: wins dedup
        nd = min(len(allpts), 2 * capn)
        dbuf = torch.zeros((2 * capn, 3), dtype=torch.float32,
                           device=self.device)
        dbuf[:nd] = allpts[:nd]
        dvalid = torch.arange(2 * capn, device=self.device) < nd
        keep = voxel_downsample_mask(dbuf, dvalid, voxel=cfg.ego_voxel_size,
                                     per_voxel=cfg.ego_map_per_voxel)
        kept = dbuf[keep][:capn]                  # dedup THEN truncate
        mbuf = torch.zeros((capn, 3), dtype=torch.float32, device=self.device)
        mbuf[:len(kept)] = kept
        self._map = mbuf
        self._map_valid = torch.arange(capn, device=self.device) < len(kept)
        self.poses.append(pose.astype(np.float32))
        return pose
