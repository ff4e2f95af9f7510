"""Visualization / debug views (optional dependencies, import-gated).

Replacement surface for `utils_visualization.py` (Open3D/plotly viewers) and
`utils_debug.py:22-93` (per-frame metric printout): headless-friendly
matplotlib projections here; the interactive 3D viewer with per-label hover
annotations (the reference's `visualize_pcd_plotly`) lives in
`utils/viz3d.py` as a self-contained HTML emitter. All viewers accept plain
numpy arrays and are no-ops when the backend is missing, so the pipeline
never takes a hard dependency on a GUI stack. A copy of
``icpflow_tpu/utils/viz.py`` (which cannot be imported without JAX); the
3D viewer is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _get_plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def save_pcd_view(points: np.ndarray, labels: Optional[np.ndarray],
                  path: str, title: str = "", max_points: int = 60000):
    """Top-down scatter of a labelled cloud to ``path`` (PNG)."""
    plt = _get_plt()
    if plt is None:
        return False
    pts = np.asarray(points)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points, False)
        pts = pts[idx]
        labels = labels[idx] if labels is not None else None
    fig, ax = plt.subplots(figsize=(8, 8))
    c = labels if labels is not None else pts[:, 2]
    ax.scatter(pts[:, 0], pts[:, 1], c=c, s=0.5, cmap="tab20")
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def save_flow_view(points: np.ndarray, flow: np.ndarray, path: str,
                   title: str = "", stride: int = 20):
    """Quiver view of per-point flow (top-down)."""
    plt = _get_plt()
    if plt is None:
        return False
    p = np.asarray(points)[::stride]
    f = np.asarray(flow)[::stride]
    fig, ax = plt.subplots(figsize=(8, 8))
    mag = np.linalg.norm(f[:, :2], axis=1)
    ax.quiver(p[:, 0], p[:, 1], f[:, 0], f[:, 1], mag,
              angles="xy", scale_units="xy", scale=1.0, cmap="viridis",
              width=0.002)
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def debug_frame(result: dict, prefix: str = "/tmp/icpflow_debug"):
    """Per-frame debug dump: views + per-segment EPE table.

    ``result`` follows the reference layout (`main.py:242-255`): src, dst,
    src_label, dst_label, pairs, transformations, flow, pose, scene_flow.
    """
    src = result["src"]
    flow = result["flow"]
    gt = result.get("scene_flow")
    save_pcd_view(src, result.get("src_label"), prefix + "_labels.png",
                  "src labels")
    save_flow_view(src, flow, prefix + "_flow.png", "predicted flow")
    lines = []
    if gt is not None:
        labels = np.asarray(result["src_label"]).astype(int)
        for unq in np.unique(labels):
            sel = labels == unq
            epe = float(np.linalg.norm(flow[sel] - gt[sel], axis=1).mean())
            lines.append(f"segment {unq:6d}: n={int(sel.sum()):6d} "
                         f"epe={epe:.4f}")
    report = "\n".join(lines)
    with open(prefix + "_segments.txt", "w") as f:
        f.write(report + "\n")
    return report


def trackers_to_labels(label_src, label_dst, pairs):
    """Re-label matched clusters so corresponding instances share track ids.

    Ref `utils_helper.py:49-74` (trackers2labels): ground stays, unmatched
    clustered points become -1, matched pairs get their pair index as the
    shared track id (first occurrence wins for many-to-one dst labels).
    """
    label_src = np.asarray(label_src).copy()
    label_dst = np.asarray(label_dst).copy()
    out_src = np.where(label_src >= 0, -1, label_src)
    out_dst = np.where(label_dst >= 0, -1, label_dst)
    pairs = np.asarray(pairs)
    for k, pair in enumerate(pairs):
        out_src[label_src == int(pair[0])] = k
        first = np.flatnonzero(pairs[:, 1] == pair[1])
        out_dst[label_dst == int(pair[1])] = int(first[0])
    return out_src, out_dst
