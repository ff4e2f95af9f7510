"""Seeded samples in PCAccumulation's npz format (the schema of its Waymo
and nuScenes splits, ICP-Flow ``dataset_pca.py:30-113``): each a sequence
of raw sensor-frame sweeps with GT ego poses, per-instance motion and
static/dynamic and foreground/background labels, written to one ``.npz``
for the program's loader to read back.

A sample is ``scenes.py``'s scene (its ground, walls, statics and three
movers, plus the mix's ``extra`` groups placed by ``layout_seed`` and the
sample's index) swept at ``hz``: the ego and every mover move and turn
``10 / hz`` of ``scenes.py``'s 10 Hz step a sweep. Each sweep keeps every
``sweep_thin``-th of the scene's points, the stand-in for a sparser
lidar. A point's ``sd_labels`` and ``fb_labels`` are 1 on a mover and 0
elsewhere, as ``data/synthetic.py`` sets them. ``--seed`` draws the sensor
noise, the dropout and the order in which the samples are served, as in
``scenes.py``; the objects, their motion and the frame count come from the
mix alone.

A mix (``traffic/<name>.json``) holds:

* ``generator``: ``"pca_samples"``; ``form``: ``"samples"``;
* ``samples``: how many, each from its own stream of the seed;
* ``frames``: sweeps a sample; ``hz``: the sweep rate;
* ``sweep_thin``: keep every ``sweep_thin``-th point of a sweep;
* ``extra`` (optional): as in ``scenes.py``;
* ``crop``: the half width of the square the program crops to (its
  ``range_x``, ``range_y``), and ``max_points``: every sweep's points
  inside it must fit this bucket, or the mix is refused;
* ``thin`` (optional): keep every ``thin``-th point besides (the tests'
  small mixes).

``make`` writes the samples under ``benchmark/.cache/`` in a directory of
the process's own, removed when the process exits, and returns one dict a
sample: ``path`` (the ``.npz``) and ``arrays`` (what it holds).
"""

from __future__ import annotations

import atexit
import pathlib
import shutil
import tempfile

import numpy as np

from benchmark.traffic import scenes

CACHE = pathlib.Path(__file__).resolve().parents[1] / ".cache"
POINT_KEYS = ("raw_points", "time_indice", "sd_labels", "fb_labels",
              "inst_labels")


def sample(seed_seq, frames: int, hz: float, sweep_thin: int,
           extra: dict | None = None, index: int = 0) -> dict:
    """Sample ``index``: ``frames`` sweeps at ``hz`` as the npz's arrays;
    its noise and dropout from ``seed_seq``."""
    rng = np.random.default_rng(seed_seq)
    scale = 10.0 / hz
    ground = scenes._ground(rng)
    statics = [scenes._box_pts(rng, c, s, yaw=y)
               for c, s, y in scenes.BASE_STATICS]
    movers = list(scenes.BASE_MOVERS)
    if extra:
        more_statics, more_movers = scenes.extra_objects(extra, index)
        statics += [scenes._box_pts(rng, c, s, yaw=y, step=st)
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
            center = start + np.asarray(vel) * scale * j
            yaw = yaw_rate * scale * j
            body = scenes._box_pts(rng, center, size, yaw=yaw, step=step)
            world.append(body)
            inst.append(np.full(len(body), mi))
            R = scenes._rot_z(-yaw)
            M = np.eye(4, dtype=np.float32)
            M[:3, :3] = R
            M[:3, 3] = start - R @ center
            inst_T[mi, j] = M
        world = np.concatenate(world)[::sweep_thin]
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = scenes.EGO_V * scale * j
        ego_T[j] = T
        pts_all.append((world - T[:3, 3]).astype(np.float32))
        ti_all.append(np.full(len(world), j))
        inst_all.append(np.concatenate(inst)[::sweep_thin])
    inst = np.concatenate(inst_all).astype(np.int64)
    moving = (inst > 0).astype(np.int64)
    return dict(raw_points=np.concatenate(pts_all).astype(np.float32),
                time_indice=np.concatenate(ti_all).astype(np.int64),
                sd_labels=moving, fb_labels=moving.copy(),
                inst_labels=inst, ego_motion_gt=ego_T, bbox_tsfm=inst_T)


def thinned(arrays: dict, thin: int) -> dict:
    """Every ``thin``-th point of each sweep (per-point arrays only)."""
    ti = arrays["time_indice"]
    keep = np.concatenate([np.flatnonzero(ti == j)[::thin]
                           for j in np.unique(ti)])
    return {k: (v[keep] if k in POINT_KEYS else v)
            for k, v in arrays.items()}


def sweep_sizes(arrays: dict, crop: float) -> np.ndarray:
    """Points of each sweep inside the |x|, |y| < ``crop`` square."""
    raw, ti = arrays["raw_points"], arrays["time_indice"]
    inside = np.logical_and(np.abs(raw[:, 0]) < crop,
                            np.abs(raw[:, 1]) < crop)
    return np.bincount(ti[inside], minlength=int(ti.max()) + 1)


def _write(folder: pathlib.Path, name: str, arrays: dict) -> str:
    path = folder / f"{name}.npz"
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return str(path)


def make(mix: dict, seed: int) -> list:
    """The mix's samples from ``seed``, in the seed's order, each written
    to an ``.npz``: a list of ``{"path", "arrays"}``. ``seed`` is any
    integer (taken modulo 2**64)."""
    if mix["form"] != "samples":
        raise ValueError(f"unknown form {mix['form']!r}")
    count = int(mix["samples"])
    root = np.random.SeedSequence(int(seed) % (1 << 64))
    order_ss, *streams = root.spawn(count + 1)
    thin = int(mix.get("thin", 1))
    samples = []
    for index, ss in enumerate(streams):
        arrays = sample(ss, int(mix["frames"]), float(mix["hz"]),
                        int(mix["sweep_thin"]), mix.get("extra"), index)
        if thin > 1:
            arrays = thinned(arrays, thin)
        worst = int(sweep_sizes(arrays, float(mix["crop"])).max())
        if worst > int(mix["max_points"]):
            raise ValueError(f"a sweep of {worst} points exceeds the mix's "
                             f"bucket of {mix['max_points']}")
        samples.append(arrays)
    CACHE.mkdir(parents=True, exist_ok=True)
    folder = pathlib.Path(tempfile.mkdtemp(prefix="pca_samples-",
                                           dir=CACHE))
    atexit.register(shutil.rmtree, folder, True)
    items = [{"path": _write(folder, f"sample_{i:02d}", a), "arrays": a}
             for i, a in enumerate(samples)]
    return [items[i] for i in
            np.random.default_rng(order_ss).permutation(count)]
