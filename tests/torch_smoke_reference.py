"""Reference numbers for ``chip_smoke.py``, from the JAX package on the CPU.

    python3 tests/torch_smoke_reference.py

Runs, on XLA:CPU at the bench configuration, on exactly the inputs
``chip_smoke.py`` gives the port (synthetic scene, seed 7):

* ``icpflow_tpu.pipeline.run_frame_pair`` on the frame pairs of gaps 1 and
  4, printing per gap the numbers ``chip_smoke.JAX_REFERENCE`` pins: EPE3D,
  dynamic EPE and matched pairs;
* ``icpflow_tpu.models.streaming.StreamingEngine`` with ego odometry over
  the five sensor-frame scans, printing per frame the numbers
  ``chip_smoke.JAX_STREAM_REFERENCE`` pins: the pose, EPE3D and dynamic EPE
  against the GT flow to the previous frame, and matched pairs.

The stream runs with ``ego_map_capacity`` and ``ego_src_capacity`` cut to
the smallest powers of two that hold the map and the registration source
(the XLA:CPU exact NN sweep is slow at full capacity). The results do not
depend on the padded capacities while the map never fills (it is deduped
before it is truncated) and the source never overflows; the script prints
the fill counts to show that. Needs JAX; the port's machine has none,
hence the pinned constants. Pass ``--stream`` to run only the stream.

    python3 tests/torch_smoke_reference.py --offline

runs instead ``icpflow_tpu.cli.run`` over the scenes of seeds 7 and 8
written as PCAccumulation-format samples, each with GT poses and with
``--if_kiss_icp`` (the odometry at the same cut capacities, fill counts
printed), exactly as ``chip_smoke.run_offline`` drives the port's CLI, and
prints what ``chip_smoke.JAX_OFFLINE_REFERENCE`` pins: the meters, the
non-ground points per frame, the labelled clusters per pair and the
estimated poses. About 8 minutes on this repository's 8-core CPU test host
with a warm XLA compilation cache (jax 0.9.0; 55-195 s a run).

    python3 tests/torch_smoke_reference.py --hdbscan

runs instead ``use_hdbscan=True`` at the bench configuration: the frame
pairs of gaps 1 and 4, gap 1 with ``hdbscan_exact=False``, and
``cli.run --if_hdbscan`` over seed 7 with GT poses, printing what
``chip_smoke.JAX_HDBSCAN_REFERENCE`` pins: EPE3D, dynamic EPE, matched
pairs, labelled clusters and occupied voxels per pair, and the offline
meters with the clusters per pair. About an hour on the same host (jax
0.9.0; 5-7 minutes a pair, 27 for the voxel-hash pair, 18 for the offline
sample: XLA:CPU sweeps every slot of the 32,768-slot representative
bucket, and sorts every point's 5,184 voxel-hash candidates).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--sharded" in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=4")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


STREAM_CAPACITY = dict(ego_map_capacity=65536, ego_src_capacity=4096)


def frame_pairs(cfg):
    from icpflow_tpu import SceneFlowEngine
    from icpflow_tpu.pipeline import run_frame_pair
    engine = SceneFlowEngine(cfg)
    out = {}
    for gap, src, dst, gt, dyn, tf in chip_smoke.scene_pairs(cfg):
        t0 = time.time()
        res = run_frame_pair(engine, src, dst, translation_frame=tf,
                             pose=np.eye(4, dtype=np.float32))
        m = chip_smoke.pair_metrics(res.flow, gt, dyn, res.pairs)
        m.update(n_src=len(src), n_dst=len(dst), overflow=res.overflow,
                 seconds=round(time.time() - t0, 1))
        out[gap] = m
        print(f"gap {gap}: {json.dumps(m)}", flush=True)
    return out


def stream(cfg):
    import jax.numpy as jnp
    from icpflow_tpu.models.streaming import StreamingEngine
    from icpflow_tpu.ops.ego import voxel_downsample_mask
    cfg = cfg.replace(**STREAM_CAPACITY)
    scans, ego_gt, gts, dyns = chip_smoke.stream_frames()
    eng = StreamingEngine(cfg, estimate_ego=True)
    out = {}
    for k, scan in enumerate(scans):
        t0 = time.time()
        res = eng.process(scan)
        odo = eng.odo
        # the registration source of this frame, as register_frame builds it
        r = np.linalg.norm(scan, axis=1)
        f = scan[(r > cfg.ego_min_range) & (r < cfg.ego_max_range)]
        keep = voxel_downsample_mask(jnp.asarray(f), jnp.ones(len(f), bool),
                                     voxel=cfg.ego_voxel_size * 0.5)
        n_src = int(np.asarray(voxel_downsample_mask(
            jnp.asarray(f), keep, voxel=cfg.ego_voxel_size * 1.5)).sum())
        fill = int(odo._map_valid.sum())
        assert fill < cfg.ego_map_capacity and n_src < cfg.ego_src_capacity
        m = dict(map_fill=fill, map_capacity=cfg.ego_map_capacity,
                 src_points=n_src, src_capacity=cfg.ego_src_capacity,
                 seconds=round(time.time() - t0, 1))
        if res is not None:
            m.update(chip_smoke.pair_metrics(res.flow, gts[k], dyns[k],
                                             res.pairs))
            m["pose"] = [[float(v) for v in row] for row in res.pose[:3]]
            m["pose_err_vs_gt"] = chip_smoke.pose_error(res.pose, ego_gt[k])
            out[k] = m
        print(f"frame {k}: {json.dumps(m)}", flush=True)
    return out


@contextlib.contextmanager
def ego_fills(cfg, fills):
    """Append (map fill, registration source points) of every frame the JAX
    package's odometry registers inside the block to ``fills``."""
    import jax.numpy as jnp
    from icpflow_tpu.ops import ego
    orig = ego.EgoOdometry.register_frame

    def register_frame(self, frame):
        pose = orig(self, frame)
        r = np.linalg.norm(frame[:, :3], axis=1)
        f = frame[(r > cfg.ego_min_range) & (r < cfg.ego_max_range), :3]
        keep = ego.voxel_downsample_mask(
            jnp.asarray(f), jnp.ones(len(f), bool),
            voxel=cfg.ego_voxel_size * 0.5)
        n_src = int(np.asarray(ego.voxel_downsample_mask(
            jnp.asarray(f), keep, voxel=cfg.ego_voxel_size * 1.5)).sum())
        fills.append((int(self._map_valid.sum()), n_src))
        return pose

    ego.EgoOdometry.register_frame = register_frame
    try:
        yield
    finally:
        ego.EgoOdometry.register_frame = orig


def offline():
    from icpflow_tpu import cli
    from icpflow_tpu.config import PipelineConfig
    from icpflow_tpu.data.pca import DatasetPCA
    out = {}
    for seed in chip_smoke.OFFLINE_SEEDS:
        for kiss in (False, True):
            cfg = chip_smoke.offline_config(kiss)
            if kiss:
                cfg = cfg.replace(**STREAM_CAPACITY)
            cfg = PipelineConfig(**dataclasses.asdict(cfg))
            fills = []
            with ego_fills(cfg, fills):
                meters, data, pairs, seconds, _ = chip_smoke.run_offline(
                    cli, DatasetPCA, cfg, seed, kiss)
            nonground, clusters = chip_smoke.offline_counts(pairs)
            m = dict(meters={k: meters[k]
                             for k in chip_smoke.offline_meter_names()},
                     nonground=nonground, clusters=clusters,
                     points=[int((data["time_indice"] == j).sum())
                             for j in range(cfg.num_frames)],
                     seconds=round(seconds, 1))
            if kiss:
                assert all(f < cfg.ego_map_capacity
                           and n < cfg.ego_src_capacity for f, n in fills)
                m.update(
                    poses=[[[float(v) for v in row] for row in pose[:3]]
                           for pose in data["ego_poses"]],
                    pose_err_vs_gt=[chip_smoke.pose_error(p, g) for p, g in
                                    zip(data["ego_poses"],
                                        data["ego_motion_gt"])],
                    map_fill=[f for f, _ in fills],
                    src_points=[n for _, n in fills],
                    map_capacity=cfg.ego_map_capacity,
                    src_capacity=cfg.ego_src_capacity)
            out.setdefault(seed, {})["kiss" if kiss else "gt"] = m
            print(f"seed {seed} {'kiss' if kiss else 'gt'}: {json.dumps(m)}",
                  flush=True)
    return out


def _n_unique(cfg, src, dst):
    """Occupied hdbscan voxels of the joint cloud hdbscan clusters: dst then
    src, each padded to its bucket as ``run_frame_pair`` pads it."""
    import jax.numpy as jnp
    from icpflow_tpu import SceneFlowEngine
    from icpflow_tpu.ops.cluster import voxel_dedup_compact
    engine = SceneFlowEngine(cfg)
    (pd, vd), (ps, vs) = engine.pad_cloud(dst), engine.pad_cloud(src)
    out = voxel_dedup_compact(jnp.asarray(np.concatenate([pd, ps])),
                              jnp.asarray(np.concatenate([vd, vs])),
                              voxel=cfg.hdbscan_dedup_voxel,
                              cap=cfg.hdbscan_rep_cap)
    return int(out[-1])


def hdbscan():
    """``use_hdbscan=True`` at the bench configuration: the frame pairs of
    gaps 1 and 4 (exact graph over the voxel representatives), gap 1 on the
    voxel-hash graph (``hdbscan_exact=False``), and ``cli.run
    --if_hdbscan`` over seed 7 with GT poses. Prints what
    ``chip_smoke.JAX_HDBSCAN_REFERENCE`` pins."""
    from icpflow_tpu import SceneFlowEngine, cli
    from icpflow_tpu.config import PipelineConfig
    from icpflow_tpu.data.pca import DatasetPCA
    from icpflow_tpu.ops import hdbscan as jhd
    from icpflow_tpu.pipeline import run_frame_pair
    out = {}
    for exact in (True, False):
        cfg = PipelineConfig(**dataclasses.asdict(
            chip_smoke.hdbscan_config(exact)))
        engine = SceneFlowEngine(cfg)
        gaps = chip_smoke.GAPS if exact else (1,)
        for gap, src, dst, gt, dyn, tf in chip_smoke.scene_pairs(cfg, gaps=gaps):
            t0 = time.time()
            before = jhd.DEDUP_OVERFLOWS
            res = run_frame_pair(engine, src, dst, translation_frame=tf,
                                 pose=np.eye(4, dtype=np.float32))
            m = chip_smoke.pair_metrics(res.flow, gt, dyn, res.pairs)
            m.update(clusters=chip_smoke.pair_clusters(res.labels_src,
                                                       res.labels_dst),
                     n_src=len(src), n_dst=len(dst), overflow=res.overflow,
                     dedup_overflows=jhd.DEDUP_OVERFLOWS - before,
                     seconds=round(time.time() - t0, 1))
            if exact:
                m["n_unique"] = _n_unique(cfg, src, dst)
            key = gap if exact else "voxel_hash"
            out[key] = m
            print(f"{key}: {json.dumps(m)}", flush=True)
    cfg = PipelineConfig(**dataclasses.asdict(chip_smoke.offline_config(
        False).replace(use_hdbscan=True)))
    meters, data, pairs, seconds, _ = chip_smoke.run_offline(
        cli, DatasetPCA, cfg, chip_smoke.SEED, False)
    nonground, clusters = chip_smoke.offline_counts(pairs)
    m = dict(meters={k: meters[k] for k in chip_smoke.offline_meter_names()},
             nonground=nonground, clusters=clusters,
             points=[int((data["time_indice"] == j).sum())
                     for j in range(cfg.num_frames)],
             seconds=round(seconds, 1))
    out["offline"] = m
    print(f"offline: {json.dumps(m)}", flush=True)
    return out


@contextlib.contextmanager
def pair_overflows(out):
    """Record ``{translation_frame: overflow}`` of every frame pair that the
    JAX package's sharded step matches inside the block. The matcher runs
    traced inside ``shard_map``; a debug callback hands the host each
    device's value (the same on every cp device after the matcher's psum),
    and a pair's search radius names it."""
    from icpflow_tpu.parallel import shard
    orig = shard.match_frame_pair

    def record(tf, overflow):
        out[round(float(tf), 5)] = int(overflow)

    def match(seg_src, seg_dst, translation_frame, cfg, **kw):
        res = orig(seg_src, seg_dst, translation_frame, cfg, **kw)
        jax.debug.callback(record, translation_frame, res.overflow)
        return res

    shard.match_frame_pair = match
    try:
        yield
    finally:
        shard.match_frame_pair = orig


def sharded():
    """``cli.run --dp 2 --cp 2`` over seed 7 with GT poses: the meters, the
    labelled clusters and the overflow of each frame pair."""
    from icpflow_tpu import cli
    from icpflow_tpu.config import PipelineConfig
    from icpflow_tpu.data.pca import DatasetPCA
    assert len(jax.devices()) >= 4, jax.devices()
    cfg = PipelineConfig(**dataclasses.asdict(
        chip_smoke.offline_config(False)))
    overflows = {}
    with pair_overflows(overflows):
        meters, data, pairs, seconds, lines = chip_smoke.run_offline(
            cli, DatasetPCA, cfg, chip_smoke.SEED, False,
            extra=chip_smoke.SHARDED_ARGV)
    assert any("sharded step over mesh dp=2 cp=2" in ln for ln in lines)
    _, clusters = chip_smoke.offline_counts(pairs)
    tfs = [round(float(np.float32(max(
        cfg.speed * j, float(np.linalg.norm(data["ego_poses"][j][:3, 3])))
        * 2.0)), 5) for j in range(1, cfg.num_frames)]
    m = dict(meters={k: meters[k] for k in chip_smoke.offline_meter_names()},
             clusters=clusters, overflow=[overflows[tf] for tf in tfs],
             seconds=round(seconds, 1))
    print(f"sharded: {json.dumps(m)}", flush=True)
    return m


def main():
    jax.config.update("jax_platforms", "cpu")
    from icpflow_tpu.config import PipelineConfig

    if "--sharded" in sys.argv:
        print(json.dumps({"jax_backend": jax.default_backend(),
                          "jax": jax.__version__,
                          "sharded_reference": sharded()}))
        return

    if "--hdbscan" in sys.argv:
        print(json.dumps({"jax_backend": jax.default_backend(),
                          "jax": jax.__version__,
                          "hdbscan_reference": hdbscan()}))
        return
    if "--offline" in sys.argv:
        print(json.dumps({"jax_backend": jax.default_backend(),
                          "jax": jax.__version__,
                          "offline_reference": offline()}))
        return
    cfg = PipelineConfig(**dataclasses.asdict(chip_smoke.bench_config()))
    result = {"jax_backend": jax.default_backend()}
    if "--stream" not in sys.argv:
        result["reference"] = frame_pairs(cfg)
    result["stream_reference"] = stream(cfg)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
