"""The result line of a run, and the runs that must print none."""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.manifest import Manifest

REPO = pathlib.Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [0, 1])
def test_line_keys(small_root, trace):
    out = harness.run_cell("av2_pairs.sparse", 2 ** 31 + 9, 0.5, bool(trace),
                           "cpu", root=small_root)
    line = json.loads(json.dumps(out["line"]))
    assert KEYS <= set(line) <= KEYS | {"breakdown", "check"}
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        # a CPU run reads no device: the device metrics are left out, and
        # so is host_syncs, which counts synchronizing CUDA calls; every
        # other per-layer metric of the cell is there
        host = {m["name"] for m in Manifest(small_root).metrics(
            "av2_pairs.sparse", True) if m["source"] != "device_trace"}
        assert names == host - {"host_syncs.pair"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == {"pairs_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}


def test_stream_line(small_root):
    out = harness.run_cell("av2_stream.sessions16", 4, 0.5, False, "cpu",
                           root=small_root)
    line = out["line"]
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p90",
                                    "setup_s"}
    assert line["correct"] is True
    assert line["check"]


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "av2_pairs.sparse",
         "--seed", "1", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is here")
    res = _run(REPO)
    assert res.returncode != 0 and res.stdout == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
