"""Synthetic lidar scene generator (PCA-format samples).

Real-data Waymo/nuScenes samples are not distributable with the repo; this
generator produces PCAccumulation-format npz samples with lidar-like
statistics — polar ray sampling (density falls with range), ground + walls +
poles, multiple movers with yaw rotation, multi-frame GT ego and
per-instance motion — so the full `DatasetPCA` -> CLI path (ground removal,
hdbscan/DBSCAN, multi-gap matching, metric sweep) can be exercised and
regression-tested end-to-end at realistic density structure.
"""

from __future__ import annotations

import numpy as np


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def lidar_scene(rng, *, n_ground=14000, n_beams=24, sensor_height=1.9):
    """Static world sampled like a spinning lidar: ground rings + boxes."""
    # ground: concentric rings, ring spacing grows with range (beam geometry)
    ranges = sensor_height / np.tan(np.radians(
        np.linspace(2.0, 24.0, n_beams)))
    g = []
    for r in ranges:
        n = max(30, int(2 * np.pi * r / 0.25))
        az = rng.uniform(0, 2 * np.pi, n)
        g.append(np.stack([
            r * np.cos(az), r * np.sin(az),
            np.full(n, -sensor_height) + rng.normal(scale=0.02, size=n)], 1))
    ground = np.concatenate(g)[:n_ground].astype(np.float32)

    def box_pts(center, size, yaw=0.0, step=0.08):
        """Surface-sampled box with range-dependent dropout."""
        cx, cy, cz = center
        sx, sy, sz = size
        faces = []
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            u = np.arange(-0.5, 0.5, step / max(sx, sy))
            v = np.arange(0.0, 1.0, step / sz)
            uu, vv = np.meshgrid(u, v)
            if axis == 0:
                f = np.stack([np.full_like(uu, 0.5 * sign) * sx,
                              uu * sy,
                              vv * sz - sz / 2], -1).reshape(-1, 3)
            else:
                f = np.stack([uu * sx, np.full_like(uu, 0.5 * sign) * sy,
                              vv * sz - sz / 2], -1).reshape(-1, 3)
            faces.append(f)
        pts = np.concatenate(faces) @ _rot_z(yaw).T + [cx, cy, cz]
        rng_dist = np.linalg.norm(pts[:, :2], axis=1)
        keep = rng.random(len(pts)) < np.clip(12.0 / (rng_dist + 1e-3), 0, 1)
        pts = pts[keep]
        return (pts + rng.normal(scale=0.015, size=pts.shape)).astype(
            np.float32)

    wall1 = box_pts([0, 22, -sensor_height + 1.5], [45, 0.4, 3.0])
    wall2 = box_pts([-25, 0, -sensor_height + 1.5], [0.4, 40, 3.0])
    statics = [box_pts([8, -6, -sensor_height + 0.8], [4.4, 1.9, 1.6],
                       yaw=0.3),
               box_pts([-10, 9, -sensor_height + 0.8], [4.2, 1.8, 1.5],
                       yaw=-1.1),
               box_pts([15, 11, -sensor_height + 1.0], [0.3, 0.3, 2.0])]
    return ground, [wall1, wall2] + statics, box_pts


def make_sample(path: str, *, num_frames: int = 5, seed: int = 0,
                sensor_height: float = 1.9):
    """Write one PCA-format npz (dataset_pca.py:30-113 schema)."""
    rng = np.random.default_rng(seed)
    ground, statics, box_pts = lidar_scene(rng, sensor_height=sensor_height)

    # movers: (start, velocity m/frame, yaw_rate rad/frame, size)
    movers = [
        (np.array([-6.0, -12.0, -sensor_height + 0.8]),
         np.array([1.4, 0.25, 0.0]), 0.03, [4.5, 1.9, 1.6]),
        (np.array([12.0, 4.0, -sensor_height + 0.9]),
         np.array([-0.9, 0.55, 0.0]), -0.05, [4.2, 1.8, 1.5]),
        (np.array([2.0, 14.0, -sensor_height + 0.9]),
         np.array([0.25, -0.12, 0.0]), 0.0, [0.6, 0.6, 1.8]),  # pedestrian
    ]
    ego_v = np.array([1.1, 0.1, 0.0])

    pts_all, ti_all, sd_all, fb_all, inst_all = [], [], [], [], []
    ego_T = np.zeros((num_frames, 4, 4), np.float32)
    n_inst = 1 + len(movers)
    inst_T = np.zeros((n_inst, num_frames, 4, 4), np.float32)
    inst_T[:, :] = np.eye(4)

    for j in range(num_frames):
        world = [ground + rng.normal(scale=0.01, size=ground.shape
                                     ).astype(np.float32)]
        sd, fb, inst = [np.zeros(len(ground))], [np.zeros(len(ground))], \
            [np.zeros(len(ground))]
        for s in statics:
            world.append(s + rng.normal(scale=0.01, size=s.shape
                                        ).astype(np.float32))
            sd.append(np.zeros(len(s)))
            fb.append(np.zeros(len(s)))
            inst.append(np.zeros(len(s)))
        for mi, (start, vel, yaw_rate, size) in enumerate(movers, start=1):
            center = start + vel * j
            yaw = yaw_rate * j
            body = box_pts(center, size, yaw=yaw)
            world.append(body)
            sd.append(np.ones(len(body)))
            fb.append(np.ones(len(body)))
            inst.append(np.full(len(body), mi))
            # transform mapping frame-j ego-compensated pts -> frame-0 state
            R = _rot_z(-yaw)
            M = np.eye(4, dtype=np.float32)
            M[:3, :3] = R
            M[:3, 3] = start - R @ center
            inst_T[mi, j] = M

        world = np.concatenate(world)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = ego_v * j
        ego_T[j] = T
        sensor = (world - T[:3, 3]).astype(np.float32)
        pts_all.append(sensor)
        ti_all.append(np.full(len(sensor), j))
        sd_all.append(np.concatenate(sd))
        fb_all.append(np.concatenate(fb))
        inst_all.append(np.concatenate(inst))

    np.savez_compressed(
        path,
        raw_points=np.concatenate(pts_all).astype(np.float32),
        time_indice=np.concatenate(ti_all).astype(np.int64),
        sd_labels=np.concatenate(sd_all).astype(np.int64),
        fb_labels=np.concatenate(fb_all).astype(np.int64),
        inst_labels=np.concatenate(inst_all).astype(np.int64),
        sem_labels=np.concatenate(inst_all).astype(np.int64),
        ego_motion_gt=ego_T,
        bbox_tsfm=inst_T,
    )
    return path


def ego_aligned_pair(sample, j: int, *, ground_z: float = -1.6):
    """Frame pair (src = frame ``j``, dst = frame 0) of a ``make_sample``
    scene, the way the held-out protocol feeds the pipeline.

    Ground is removed by a z crop in the sensor frame (``z > ground_z``);
    both frames are ego-aligned with the GT ego poses; the GT flow of a
    source point is its instance's ``bbox_tsfm`` motion back to frame 0
    (zero for static points).

    Returns (point_src (n,3), point_dst (m,3), gt_flow (n,3), dynamic (n,)
    bool), all float32 except ``dynamic``.
    """
    raw = np.asarray(sample["raw_points"], np.float32)
    ti = np.asarray(sample["time_indice"])
    ego = np.asarray(sample["ego_motion_gt"], np.float32)
    inst = np.asarray(sample["inst_labels"])
    sd = np.asarray(sample["sd_labels"])
    tsfm = np.asarray(sample["bbox_tsfm"], np.float32)

    def frame(k):
        sel = ti == k
        keep = raw[sel][:, 2] > ground_z
        pts = raw[sel][keep]
        world = (pts @ ego[k, :3, :3].T + ego[k, :3, 3]).astype(np.float32)
        return world, inst[sel][keep], sd[sel][keep]

    src, inst_src, sd_src = frame(j)
    dst, _, _ = frame(0)
    gt = np.zeros_like(src)
    for i in np.unique(inst_src[inst_src > 0]):
        m = inst_src == i
        M = tsfm[int(i), j]
        gt[m] = src[m] @ M[:3, :3].T + M[:3, 3] - src[m]
    return src, dst, gt.astype(np.float32), sd_src > 0
