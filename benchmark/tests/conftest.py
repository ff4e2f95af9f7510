"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
under a temporary root, cut to sizes a CPU runs in seconds."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import sys

# one host thread a worker, as benchmark/run.py runs: several pytest
# workers whose thread pools each take every core stall one another
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the CLI tests' reduced buckets (icpflow_tpu_torch/bench.py SMALL_OVERRIDES)
SMALL = dict(max_points_scene=4096, max_points=512, max_pairs=32,
             pairs_small=32, pairs_large=4, hist_grid_xy=64,
             ego_map_capacity=8192, ego_src_capacity=2048)
THIN = 32


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips without one")


def make_small_root(dest: pathlib.Path) -> pathlib.Path:
    """BENCHMARK.json and the benchmark's files under ``dest``, with every
    configuration on the small buckets (a stream warmed on one scan a
    session), every mix thinned to a 32nd of its points and every stream
    session cut to 4 scans."""
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    for p in (dest / "benchmark" / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["pipeline"].update(SMALL)
        if "warm_frames" in d:
            d["warm_frames"] = 1
        p.write_text(json.dumps(d))
    for p in (dest / "benchmark" / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        d.update(thin=THIN, max_points=SMALL["max_points_scene"])
        if d["form"] == "sessions":
            d["frames"] = 4
        p.write_text(json.dumps(d))
    return dest


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(tmp_path)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
