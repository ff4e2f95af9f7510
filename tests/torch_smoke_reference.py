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
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
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


def main():
    jax.config.update("jax_platforms", "cpu")
    from icpflow_tpu.config import PipelineConfig

    cfg = PipelineConfig(**dataclasses.asdict(chip_smoke.bench_config()))
    result = {"jax_backend": jax.default_backend()}
    if "--stream" not in sys.argv:
        result["reference"] = frame_pairs(cfg)
    result["stream_reference"] = stream(cfg)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
