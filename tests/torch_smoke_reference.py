"""Reference numbers for ``chip_smoke.py``, from the JAX package on the CPU.

    python3 tests/torch_smoke_reference.py

Runs ``icpflow_tpu.pipeline.run_frame_pair`` (XLA:CPU) at the bench
configuration on exactly the frame pairs ``chip_smoke.py`` gives the port
(synthetic scene, seed 7, gaps 1 and 4) and prints, per gap, the numbers
``chip_smoke.JAX_REFERENCE`` pins: EPE3D, dynamic EPE and matched pairs.
Needs JAX; the port's machine has none, hence the pinned constants.
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


def main():
    jax.config.update("jax_platforms", "cpu")
    from icpflow_tpu import SceneFlowEngine
    from icpflow_tpu.config import PipelineConfig
    from icpflow_tpu.pipeline import run_frame_pair

    cfg = PipelineConfig(**dataclasses.asdict(chip_smoke.bench_config()))
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
    print(json.dumps({"jax_backend": jax.default_backend(),
                      "reference": out}))


if __name__ == "__main__":
    main()
