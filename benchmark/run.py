"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs an NVIDIA GPU: without one (``torch.cuda.is_available()`` false, or
fewer cards than the cell asks for) it prints no result and exits 2. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit);
the numbers compared are also the last lines of standard error. It exits
3, printing no result, if JAX or the JAX package is loaded by the time the
line would be printed: after the window, the metric readers and the
reference.

The process keeps to two fixed cores (the two highest-numbered that it may
use) and one thread for the numerical libraries: one caller's host work,
which would otherwise move between the cores of a shared host.
"""

from __future__ import annotations

import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)


def process_start() -> float:
    """``time.time()`` at which this process was created (Linux
    ``/proc``), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED_AT = process_start()


def _pin(cores: int = 2):
    """Keeps this process, and the threads it starts from now on, to the
    ``cores`` highest-numbered cores that it may use."""
    try:
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, allowed[-cores:])
    except (AttributeError, OSError):
        pass


def _set_env():
    """Kernel and build caches at fixed places inside the checkout, and one
    host thread for the numerical libraries (unless the caller sets
    another count): one caller's host work, without thread pools that
    contend for the cores of a shared host."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    cache = os.path.join(_HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_env()
    _pin()
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import json

    import torch

    from benchmark import harness
    from benchmark.manifest import Manifest

    chips = int(Manifest().cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", started_at=STARTED_AT)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    line = out["line"]
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
