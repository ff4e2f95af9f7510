"""The benchmark's one traffic generator: seeded lidar-like scenes, served
as ego-aligned frame pairs or as sessions of raw sensor scans.

The scene is a copy of the port's ``data/synthetic.py`` (``lidar_scene``,
``make_sample``, ``ego_aligned_pair``), kept here so that the traffic does
not move when the program does: polar-sampled ground rings, two walls, two
parked cars and a pole, three movers (two cars and a pedestrian), and an
ego car at 1.1 m a frame. A mix file may add objects (``extra``), placed
by the mix's ``layout_seed`` and the scene's index. What ``--seed`` draws
is the sensor noise, the dropout and the order in which the scenes are
served: the objects, their sizes and places and the frame counts come from
the mix alone, so every seed asks for about the same work.

A mix (``traffic/<name>.json``) holds:

* ``generator``: ``"scenes"``;
* ``form``: ``"pairs"`` (ego-aligned, ground-cropped clouds of frame
  ``gap`` against frame 0, as the held-out protocol feeds
  ``run_frame_pair``) or ``"sessions"`` (raw sensor-frame scans of every
  frame, as a lidar hands them to ``StreamingEngine.process``);
* ``scenes`` (pairs) or ``sessions``: how many, each from its own stream
  of the seed;
* ``frames``: frames per scene; ``gap`` (pairs): the source frame;
* ``extra`` (optional): ``layout_seed`` and a list of object groups
  ``{"kind", "count", "moving", "size", "step"}``: ``size`` the box
  (length, width, height), ``step`` its surface sampling in metres, and
  ``moving`` how many of ``count`` move;
* ``max_points``: every cloud must fit this bucket, or the mix is refused;
* ``thin`` (optional): keep every ``thin``-th point of each cloud (the
  tests' small mixes).
"""

from __future__ import annotations

import numpy as np

SENSOR_HEIGHT = 1.9
EGO_V = np.array([1.1, 0.1, 0.0])
GROUND_Z = -1.6


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _box_pts(rng, center, size, yaw=0.0, step=0.08):
    """Surface-sampled box with range-dependent dropout."""
    cx, cy, cz = center
    sx, sy, sz = size
    faces = []
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        u = np.arange(-0.5, 0.5, step / max(sx, sy))
        v = np.arange(0.0, 1.0, step / sz)
        uu, vv = np.meshgrid(u, v)
        if axis == 0:
            f = np.stack([np.full_like(uu, 0.5 * sign) * sx, uu * sy,
                          vv * sz - sz / 2], -1).reshape(-1, 3)
        else:
            f = np.stack([uu * sx, np.full_like(uu, 0.5 * sign) * sy,
                          vv * sz - sz / 2], -1).reshape(-1, 3)
        faces.append(f)
    pts = np.concatenate(faces) @ _rot_z(yaw).T + [cx, cy, cz]
    rng_dist = np.linalg.norm(pts[:, :2], axis=1)
    keep = rng.random(len(pts)) < np.clip(12.0 / (rng_dist + 1e-3), 0, 1)
    pts = pts[keep]
    return (pts + rng.normal(scale=0.015, size=pts.shape)).astype(np.float32)


def _ground(rng, n_ground=14000, n_beams=24):
    ranges = SENSOR_HEIGHT / np.tan(np.radians(np.linspace(2.0, 24.0,
                                                           n_beams)))
    g = []
    for r in ranges:
        n = max(30, int(2 * np.pi * r / 0.25))
        az = rng.uniform(0, 2 * np.pi, n)
        g.append(np.stack([r * np.cos(az), r * np.sin(az),
                           np.full(n, -SENSOR_HEIGHT)
                           + rng.normal(scale=0.02, size=n)], 1))
    return np.concatenate(g)[:n_ground].astype(np.float32)


# (start, velocity m/frame, yaw rate rad/frame, size, step) of the base
# scene's movers, and (center, size, yaw) of its static boxes
_H = -SENSOR_HEIGHT
BASE_MOVERS = [
    ((-6.0, -12.0, _H + 0.8), (1.4, 0.25, 0.0), 0.03, (4.5, 1.9, 1.6), 0.08),
    ((12.0, 4.0, _H + 0.9), (-0.9, 0.55, 0.0), -0.05, (4.2, 1.8, 1.5), 0.08),
    ((2.0, 14.0, _H + 0.9), (0.25, -0.12, 0.0), 0.0, (0.6, 0.6, 1.8), 0.08),
]
BASE_STATICS = [
    ((0, 22, _H + 1.5), (45, 0.4, 3.0), 0.0),
    ((-25, 0, _H + 1.5), (0.4, 40, 3.0), 0.0),
    ((8, -6, _H + 0.8), (4.4, 1.9, 1.6), 0.3),
    ((-10, 9, _H + 0.8), (4.2, 1.8, 1.5), -1.1),
    ((15, 11, _H + 1.0), (0.3, 0.3, 2.0), 0.0),
]
# where extra objects may stand: inside the walls, off the ego's lane
_AREA = ((-22.0, 20.0), (-18.0, 18.0))
_CLEAR = 3.0          # metres between object centres (and from the base's)
_EGO_LANE = 2.5       # |y| below which no extra object stands (ego's path)


def extra_objects(extra: dict, index: int) -> tuple:
    """(statics, movers) of the mix's extra groups in scene ``index``.
    Sizes, counts and which move come from the mix; positions, headings
    and speeds from ``layout_seed`` and ``index``."""
    rng = np.random.default_rng([int(extra["layout_seed"]), index])
    taken = [np.array(c[:2]) for c, *_ in BASE_STATICS[2:]] \
        + [np.array(m[0][:2]) for m in BASE_MOVERS]
    statics, movers = [], []
    for group in extra.get("groups", []):
        size = tuple(float(s) for s in group["size"])
        step = float(group["step"])
        speed = group.get("speed", (0.0, 0.0))
        for i in range(int(group["count"])):
            for _ in range(1000):
                xy = np.array([rng.uniform(*_AREA[0]), rng.uniform(*_AREA[1])])
                if abs(xy[1]) > _EGO_LANE and all(
                        np.linalg.norm(xy - t) > _CLEAR for t in taken):
                    break
            else:
                raise ValueError("no room left for an extra object")
            taken.append(xy)
            center = (xy[0], xy[1], _H + size[2] / 2)
            yaw = float(rng.uniform(-np.pi, np.pi))
            if i < int(group.get("moving", 0)):
                v = float(rng.uniform(*speed))
                vel = (v * np.cos(yaw), v * np.sin(yaw), 0.0)
                movers.append((center, vel, float(rng.uniform(-0.03, 0.03)),
                               size, step))
            else:
                statics.append((center, size, yaw, step))
    return statics, movers


def scene(seed_seq, frames: int, extra: dict | None = None,
          index: int = 0) -> dict:
    """Scene ``index`` as ``frames`` sensor-frame scans (``make_sample``'s
    arrays, in memory): ``raw_points``, ``time_indice``, ``ego_motion_gt``,
    ``inst_labels``, ``bbox_tsfm``; its noise and dropout from
    ``seed_seq``."""
    rng = np.random.default_rng(seed_seq)
    ground = _ground(rng)
    statics = [_box_pts(rng, c, s, yaw=y) for c, s, y in BASE_STATICS]
    movers = list(BASE_MOVERS)
    if extra:
        more_statics, more_movers = extra_objects(extra, index)
        statics += [_box_pts(rng, c, s, yaw=y, step=st)
                    for c, s, y, st in more_statics]
        movers += more_movers

    pts_all, ti_all, inst_all = [], [], []
    ego_T = np.zeros((frames, 4, 4), np.float32)
    inst_T = np.zeros((1 + len(movers), frames, 4, 4), np.float32)
    inst_T[:, :] = np.eye(4)
    for j in range(frames):
        world = [ground + rng.normal(scale=0.01, size=ground.shape
                                     ).astype(np.float32)]
        inst = [np.zeros(len(ground))]
        for s in statics:
            world.append(s + rng.normal(scale=0.01, size=s.shape
                                        ).astype(np.float32))
            inst.append(np.zeros(len(s)))
        for mi, (start, vel, yaw_rate, size, step) in enumerate(movers, 1):
            start = np.asarray(start)
            center = start + np.asarray(vel) * j
            yaw = yaw_rate * j
            body = _box_pts(rng, center, size, yaw=yaw, step=step)
            world.append(body)
            inst.append(np.full(len(body), mi))
            R = _rot_z(-yaw)
            M = np.eye(4, dtype=np.float32)
            M[:3, :3] = R
            M[:3, 3] = start - R @ center
            inst_T[mi, j] = M
        world = np.concatenate(world)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = EGO_V * j
        ego_T[j] = T
        pts_all.append((world - T[:3, 3]).astype(np.float32))
        ti_all.append(np.full(len(world), j))
        inst_all.append(np.concatenate(inst))
    return dict(raw_points=np.concatenate(pts_all).astype(np.float32),
                time_indice=np.concatenate(ti_all).astype(np.int64),
                ego_motion_gt=ego_T,
                inst_labels=np.concatenate(inst_all).astype(np.int64),
                bbox_tsfm=inst_T)


def ego_aligned_pair(sample: dict, j: int, ground_z: float = GROUND_Z):
    """(point_src, point_dst): frame ``j`` and frame 0, ground cropped by
    ``z > ground_z`` in the sensor frame and moved to the world by the GT
    ego poses."""
    raw, ti = sample["raw_points"], sample["time_indice"]
    ego = sample["ego_motion_gt"]

    def frame(k):
        pts = raw[ti == k]
        pts = pts[pts[:, 2] > ground_z]
        return (pts @ ego[k, :3, :3].T + ego[k, :3, 3]).astype(np.float32)

    return frame(j), frame(0)


def make(mix: dict, seed: int) -> list:
    """The mix's items from ``seed``, in the seed's order: a list of
    (point_src, point_dst) pairs, or a list of sessions, each a list of
    (n, 3) scans. ``seed`` is any integer (taken modulo 2**64)."""
    cap = int(mix["max_points"])
    frames = int(mix["frames"])
    form = mix["form"]
    if form not in ("pairs", "sessions"):
        raise ValueError(f"unknown form {form!r}")
    count = int(mix["scenes" if form == "pairs" else "sessions"])
    root = np.random.SeedSequence(int(seed) % (1 << 64))
    order_ss, *streams = root.spawn(count + 1)
    items = []
    for index, ss in enumerate(streams):
        sample = scene(ss, frames, mix.get("extra"), index)
        if form == "pairs":
            items.append(ego_aligned_pair(sample, int(mix["gap"])))
        else:
            ti = sample["time_indice"]
            items.append([sample["raw_points"][ti == k]
                          for k in range(frames)])
    items = [items[i] for i in np.random.default_rng(order_ss).permutation(
        count)]
    thin = int(mix.get("thin", 1))
    if thin > 1:
        items = [[c[::thin] for c in it] for it in items]
    clouds = [c for it in items for c in it]
    worst = max(len(c) for c in clouds)
    if worst > cap:
        raise ValueError(f"a cloud of {worst} points exceeds the mix's "
                         f"bucket of {cap}")
    return items
