"""Minimal two-frame demo.

The reference's `demo.py:74-263` surface: load a single ego-compensated,
ground-removed frame pair from an npz (demo.npz schema), cluster jointly,
track, assemble flow, report EPE against the bundled GT, optionally dump
headless visualisations. Port of ``icpflow_tpu/demo.py``: the same flags
plus ``--device`` (the GPU unless ``--device cpu``).

    python -m icpflow_tpu_torch.demo --root <dir with demo npz> [--if_show]
"""

from __future__ import annotations

import argparse
import glob
import os
import tempfile

import numpy as np

from .config import DEMO
from .data.demo import load_demo_npz
from .device import DEFAULT_DEVICE
from .metrics import compute_epe
from .models.icp_flow import SceneFlowEngine
from .pipeline import run_frame_pair


def build_parser():
    p = argparse.ArgumentParser(description="SceneFlow demo (PyTorch)")
    p.add_argument("--root", type=str, default="./",
                   help="directory containing demo npz files")
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--epsilon", type=float, default=0.6)
    p.add_argument("--max_points", type=int, default=4096)
    p.add_argument("--num_clusters", type=int, default=200)
    p.add_argument("--min_cluster_size", type=int, default=20)
    p.add_argument("--if_show", action="store_true",
                   help="save headless views to <tmp dir>/icpflow_demo_*")
    p.add_argument("--if_verbose", action="store_true",
                   help="per-segment EPE report")
    p.add_argument("--subsample", type=int, default=None)
    p.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                   help="torch device; 'cpu' runs the plain PyTorch "
                        "versions of the kernels")
    return p


def main():
    args = build_parser().parse_args()
    cfg = DEMO.replace(
        speed=args.speed, epsilon=args.epsilon, max_points=args.max_points,
        num_clusters=args.num_clusters,
        min_cluster_size=args.min_cluster_size)
    engine = SceneFlowEngine(cfg, device=args.device)

    files = sorted(glob.glob(os.path.join(args.root, "*.npz")))
    print("total files:", len(files))
    for path in files:
        data = load_demo_npz(path, subsample=args.subsample)
        res = run_frame_pair(engine, data["point_src"], data["point_dst"],
                             translation_frame=cfg.speed * 2.0)
        gt = data["scene_flow"]
        epe, accs, accr, outlier, routlier = compute_epe(res.flow, gt)
        dyn = np.linalg.norm(gt, axis=1) > 0.05
        epe_dyn = (float(np.linalg.norm((res.flow - gt)[dyn], axis=1).mean())
                   if dyn.any() else 0.0)
        print(f"{os.path.basename(path)}: EPE3D={epe:.4f} "
              f"EPE_dyn={epe_dyn:.4f} ACC3DS={accs:.4f} ACC3DR={accr:.4f} "
              f"Outlier={outlier:.4f} pairs={len(res.pairs)}")

        if args.if_show or args.if_verbose:
            from .utils.viz import debug_frame
            rep = debug_frame({
                "src": data["point_src"],
                "dst": data["point_dst"],
                "src_label": res.labels_src,
                "dst_label": res.labels_dst,
                "pairs": res.pairs,
                "transformations": res.transforms,
                "flow": res.flow,
                "pose": np.eye(4),
                "scene_flow": gt,
            }, prefix=os.path.join(tempfile.gettempdir(), "icpflow_demo"))
            if args.if_verbose:
                print(rep)
        print(f"Processed sample: {path}.")


if __name__ == "__main__":
    main()
