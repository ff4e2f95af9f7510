"""Run-log parsing + metric curve plotting.

Replacement for `utils_plot.py:13-196`: the reference's only machine-readable
trace is its printed log, so it ships a parser that recovers per-frame EPE
curves from logs and plots run-vs-run comparisons. Our CLI prints the same
style of report lines; this module parses them back and renders curves
headlessly. A copy of ``icpflow_tpu/utils/plot.py`` (which cannot be
imported without JAX).

    python -m icpflow_tpu_torch.utils.plot run_a.log run_b.log --out curves.png
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List

_LINE = re.compile(
    r"^\s*(?P<name>[a-z_]+_\d+)\s+EPE3D:\s*(?P<epe>[\d.]+)\s+"
    r"ACC3DS:\s*(?P<accs>[\d.]+)\s+ACC3DR:\s*(?P<accr>[\d.]+)\s+"
    r"Outlier:\s*(?P<outlier>[\d.]+)\s+Routlier:\s*(?P<routlier>[\d.]+)")

# also accept the reference's own format (main.py:292-296)
_LINE_REF = re.compile(
    r"^\s*(?P<name>[a-z_]+_\d+)\s*,\s*EPE3D:\s*(?P<epe>[\d.]+)\s*,\s*"
    r"ACC3DS:\s*(?P<accs>[\d.]+)\s*,\s*ACC3DR:\s*(?P<accr>[\d.]+)\s*,\s*"
    r"Outlier:\s*(?P<outlier>[\d.]+)\s*,\s*Routlier:\s*(?P<routlier>[\d.]+)")


def parse_log(path: str) -> Dict[str, Dict[str, float]]:
    """Parse a run log into {metric_name: {epe, accs, accr, outlier, routlier}}."""
    out: Dict[str, Dict[str, float]] = {}
    with open(path) as f:
        for line in f:
            m = _LINE.match(line) or _LINE_REF.match(line)
            if not m:
                continue
            d = m.groupdict()
            # the name leaves the groups before the values are read (the
            # JAX package's copy reads them first and raises ValueError on
            # every line it matches)
            name = d.pop("name")
            out[name] = {k: float(v) for k, v in d.items()}
    return out


def epe_curve(metrics: Dict[str, Dict[str, float]], category: str,
              num_frames: int) -> List[float]:
    """Per-frame EPE curve for one category (frames 1..num_frames-1)."""
    return [metrics.get(f"{category}_{j}", {}).get("epe", float("nan"))
            for j in range(1, num_frames)]


def plot_runs(paths: List[str], out: str, category: str = "overall",
              num_frames: int = 5) -> bool:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    fig, ax = plt.subplots(figsize=(7, 5))
    for p in paths:
        curve = epe_curve(parse_log(p), category, num_frames)
        ax.plot(range(1, num_frames), curve, marker="o", label=p)
    ax.set_xlabel("frame gap")
    ax.set_ylabel(f"EPE3D ({category})")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--out", default="epe_curves.png")
    ap.add_argument("--category", default="overall")
    ap.add_argument("--num_frames", type=int, default=5)
    args = ap.parse_args()
    ok = plot_runs(args.logs, args.out, args.category, args.num_frames)
    print(f"wrote {args.out}" if ok else "matplotlib unavailable")


if __name__ == "__main__":
    main()
