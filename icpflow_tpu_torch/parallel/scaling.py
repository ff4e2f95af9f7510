"""Scaling of the sharded step over dp widths.

Port of ``icpflow_tpu/parallel/scaling.py``: frame pairs per second of
``make_sharded_step`` at increasing dp widths, one rank a card (NCCL), or
``--virtual N`` gloo ranks on the CPU, which validates the collectives
only: those ranks share the host's cores, so their throughput cannot
scale.

    python -m icpflow_tpu_torch.parallel.scaling              # the cards
    python -m icpflow_tpu_torch.parallel.scaling --virtual 4  # CPU ranks

The collective fields are the step's own count of the calls it issued in
one step and their output bytes, by op (``ShardedStep.counts`` /
``nbytes``). The JAX package's ``collective_stats`` counts the collective
instructions of the compiled HLO instead, a static count of another
program, so the two are not comparable.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .mesh import local_world, make_mesh
from .shard import make_sharded_step


def default_config():
    """The JAX package's scaling configuration: a small scene bucket."""
    from ..config import DEMO
    return DEMO.replace(
        max_points_scene=8192, max_points=512, num_clusters=32,
        max_pairs=32, pairs_small=32, pairs_large=4,
        min_cluster_size=10, nn_tile=256, hist_grid_xy=64,
        icp_max_iters=10)


def _batch(cfg, b: int, device):
    """The step's inputs: random clouds and labels from fixed seeds (the
    same on every rank), identity poses, search radius 4."""
    n = cfg.max_points_scene
    dev = torch.device(device)

    def cloud(seed):
        r = np.random.default_rng(seed)
        return (torch.as_tensor(r.uniform(-10, 10, (b, n, 3)).astype(
                    np.float32), device=dev),
                torch.ones((b, n), dtype=torch.bool, device=dev),
                torch.as_tensor(r.integers(-1, cfg.num_clusters, (b, n)),
                                dtype=torch.int32, device=dev))

    return (*cloud(0), *cloud(1),
            torch.zeros((b, n, 3), device=dev),
            torch.eye(4, device=dev).expand(b, 4, 4).contiguous(),
            torch.full((b,), 4.0, device=dev))


def _measure(cfg, width: int, batch_per_device: int, iters: int, device):
    """Every rank's part of one width: a warm-up step, then ``iters``
    timed steps. Returns rank 0's result."""
    step = make_sharded_step(make_mesh(width, 1, device), cfg)
    batch = _batch(cfg, width * batch_per_device, device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    step(*batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(*batch)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return {"dp": width, "pairs_per_sec": width * batch_per_device / dt,
            "collectives_per_step": dict(step.counts),
            "collective_bytes_per_step": sum(step.nbytes.values())}


def run_scaling(widths, cfg=None, batch_per_device: int = 1, iters: int = 5,
                device=DEFAULT_DEVICE, devices: int | None = None):
    """Pairs per second of the sharded step at each dp width (cp = 1).

    ``devices`` is how many ranks may run: by default the cards of this
    host on a GPU, one on the CPU. Wider widths are skipped. Each width
    is a world of its own, the caller its rank 0."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = default_config()
    if devices is None:
        devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    results = []
    for w in widths:
        if w > devices:
            continue
        args = (cfg, w, batch_per_device, iters, str(dev))
        with local_world(w, dev, _measure, args) as backend:
            r = _measure(*args)
        r["backend"] = backend
        shared = dev.type == "cpu" or w > torch.cuda.device_count()
        # ranks on shared cores (or one card) cannot scale: the efficiency
        # then only shows the collectives work
        r["note"] = (f"{w} ranks on shared {dev.type} devices: efficiency "
                     "not meaningful" if shared and w > 1 else None)
        results.append(r)
    base = results[0]["pairs_per_sec"] / results[0]["dp"]
    for r in results:
        r["efficiency"] = r["pairs_per_sec"] / (base * r["dp"])
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="run N gloo ranks on the CPU instead of the cards")
    ap.add_argument("--widths", type=int, nargs="+", default=None)
    ap.add_argument("--json", type=str, default=None,
                    help="also append results (one object) to this file")
    args = ap.parse_args()
    if args.virtual:
        device, n_dev = "cpu", args.virtual
    else:
        device, n_dev = DEFAULT_DEVICE, torch.cuda.device_count()
    widths = args.widths or [w for w in (1, 2, 4, 8, 16, 32) if w <= n_dev]
    results = run_scaling(widths, device=device, devices=n_dev)
    for r in results:
        print(json.dumps(r))
    if args.json:
        blob = {"results": results}
        if os.path.exists(args.json):
            with open(args.json) as f:
                try:
                    prev = json.load(f)
                except json.JSONDecodeError:
                    prev = {}
            prev.setdefault("runs", []).append(blob)
            out = prev
        else:
            out = {"runs": [blob]}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
