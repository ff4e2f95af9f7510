"""Interactive 3D point-cloud viewer (self-contained HTML).

Replacement for the reference's main manual debugging tool,
``visualize_pcd_plotly`` (`utils_visualization.py:95-145`: plotly 3D scatter
with per-label hover annotations) and the Open3D viewers
(`utils_visualization.py:26-93`). This environment has neither plotly nor a
display, so the viewer emits a SELF-CONTAINED ``.html`` file: the point data
is embedded as JSON and rendered by plotly.js (loaded from CDN, with an
inline-canvas fallback message when offline). If the ``plotly`` python
package is importable it is used instead (same call surface).

Per-label hover text matches the reference (`utils_visualization.py:117-125`:
label id + point count under the cursor's cluster). A copy of
``icpflow_tpu/utils/viz3d.py`` (which cannot be imported without JAX); the
default output paths lie under ``tempfile.gettempdir()``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np

# husl-like categorical palette (reference uses seaborn husl,
# utils_visualization.py:33); fixed 20-color wheel, label -> color mod 20
_PALETTE = [
    "#f77189", "#dc8932", "#ae9d31", "#77ab31", "#33b07a",
    "#36ada4", "#38a9c5", "#3ba3ec", "#a48cf4", "#e866f4",
    "#f668c2", "#f7696d", "#e18632", "#bb9832", "#97a431",
    "#31b33e", "#35ae93", "#37abb5", "#399ed8", "#6e9bf4",
]
_NOISE_COLOR = "#c8c8c8"
_GROUND_COLOR = "#50505a"


def _label_traces(points: np.ndarray, labels: Optional[np.ndarray],
                  max_points: int, flow: Optional[np.ndarray] = None):
    pts = np.asarray(points, np.float32)[:, :3]
    if labels is None:
        labels = np.zeros(len(pts), np.int64)
    labels = np.asarray(labels).astype(np.int64)
    if flow is not None:
        flow = np.asarray(flow, np.float32)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points, False)
        pts, labels = pts[idx], labels[idx]
        flow = flow[idx] if flow is not None else None

    traces = []
    for lbl in np.unique(labels):
        sel = labels == lbl
        if lbl < -1:                       # ground sentinel (-1e8)
            color, name = _GROUND_COLOR, "ground"
        elif lbl == -1:
            color, name = _NOISE_COLOR, "noise"
        else:
            color = _PALETTE[int(lbl) % len(_PALETTE)]
            name = f"label {int(lbl)}"
        hover = f"{name}<br>{int(sel.sum())} pts"
        if flow is not None:
            mag = float(np.linalg.norm(flow[sel], axis=1).mean())
            hover += f"<br>|flow| {mag:.3f} m"
        traces.append({
            "type": "scatter3d", "mode": "markers", "name": hover.replace(
                "<br>", " / "),
            "x": np.round(pts[sel, 0], 3).tolist(),
            "y": np.round(pts[sel, 1], 3).tolist(),
            "z": np.round(pts[sel, 2], 3).tolist(),
            "marker": {"size": 1.5, "color": color},
            "hovertemplate": hover + "<extra></extra>",
        })
    return traces


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<script src="https://cdn.plot.ly/plotly-2.32.0.min.js"></script></head>
<body style="margin:0">
<div id="plot" style="width:100vw;height:100vh"></div>
<script>
var traces = {traces};
var layout = {{
  title: {title_json}, showlegend: true,
  scene: {{aspectmode: "data",
          xaxis: {{title: "x"}}, yaxis: {{title: "y"}},
          zaxis: {{title: "z"}}}},
  margin: {{l: 0, r: 0, t: 30, b: 0}}
}};
if (typeof Plotly !== "undefined") {{
  Plotly.newPlot("plot", traces, layout);
}} else {{
  document.getElementById("plot").innerText =
    "plotly.js CDN unreachable - open with network access " +
    "(data is embedded in this file)";
}}
</script></body></html>
"""


def visualize_pcd_3d(points: np.ndarray,
                     labels: Optional[np.ndarray] = None,
                     path: Optional[str] = None,
                     title: str = "icpflow",
                     max_points: int = 200000,
                     flow: Optional[np.ndarray] = None) -> str:
    """Write an interactive 3D scatter of a labelled cloud; returns path.

    One trace per cluster label with hover annotations (label id, point
    count, mean |flow| when given) — `utils_visualization.py:95-145` parity.
    ``path`` defaults to ``icpflow_pcd.html`` in the temporary directory.
    """
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "icpflow_pcd.html")
    traces = _label_traces(points, labels, max_points, flow)
    try:
        import plotly.graph_objects as go  # optional fast path

        fig = go.Figure([go.Scatter3d(**t) for t in
                         ({k: v for k, v in tr.items() if k != "type"}
                          for tr in traces)])
        fig.update_layout(title=title, scene=dict(aspectmode="data"))
        fig.write_html(path, include_plotlyjs="cdn")
        return path
    except Exception:
        pass
    html = _HTML.format(title=title, title_json=json.dumps(title),
                        traces=json.dumps(traces))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


def visualize_registration_3d(src: np.ndarray, dst: np.ndarray,
                              transform: Optional[np.ndarray] = None,
                              path: Optional[str] = None,
                              max_points: int = 100000) -> str:
    """Registration viewer (`utils_visualization.py:13-19` parity): src
    (moved by ``transform`` when given) in orange vs dst in blue. ``path``
    defaults to ``icpflow_reg.html`` in the temporary directory."""
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "icpflow_reg.html")
    src = np.asarray(src, np.float32)[:, :3]
    dst = np.asarray(dst, np.float32)[:, :3]
    if transform is not None:
        T = np.asarray(transform, np.float32)
        src = src @ T[:3, :3].T + T[:3, 3]
    pts = np.concatenate([src, dst])
    labels = np.concatenate(
        [np.zeros(len(src), np.int64), np.ones(len(dst), np.int64)])
    return visualize_pcd_3d(pts, labels, path=path, title="registration",
                            max_points=max_points)
