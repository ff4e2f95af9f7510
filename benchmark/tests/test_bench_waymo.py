"""The Waymo cell, ``waymo_cli.full5``, and the gap-4 pair cell,
``av2_pairs.gap4``, on the CPU: found by name with their metrics, their
mixes at full size (sweeps past the 131,072 bucket; 8 m windows), both
cells run at small size, and the cell's own readers silent where their
record holds nothing to read."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.manifest import Manifest
from benchmark.traffic import pca_samples

WAYMO = "waymo_cli.full5"
GAP4 = "av2_pairs.gap4"
BIG_SEED = 2 ** 31 + 9876
OFFLINE = {"load_ms.offline", "ground_ms.offline", "cluster_ms.offline",
           "track_ms.offline", "hist_init_ms.offline", "icp_iters.offline",
           "score_ms.offline", "device_idle_share.offline",
           "nn_kernel_roofline.offline", "icp_graph_hit_share.offline",
           "cluster_fill.offline", "icp_ms.offline", "nn_kernel_ms.offline",
           "host_syncs.offline"}
# the readers that only this cell lists
OWN = ("cluster_fill.offline", "icp_ms.offline", "nn_kernel_ms.offline",
       "host_syncs.offline")
DEVICE = {"device_idle_share.offline", "nn_kernel_roofline.offline",
          "icp_graph_hit_share.offline", "nn_kernel_ms.offline",
          "host_syncs.offline"}


def test_both_cells_are_found_by_name_with_their_metrics():
    man = Manifest()
    dense = {m["name"] for m in man.metrics("av2_pairs.dense", True)}
    assert {m["name"] for m in man.metrics(GAP4, True)} == dense
    assert {m["name"] for m in man.metrics(WAYMO, True)} == OFFLINE
    for cell in (WAYMO, GAP4):
        assert man.cell(cell)["chips"] == 1
        assert {m["name"] for m in man.metrics(cell, False)} == \
            {"pairs_per_s", "setup_s"}
        assert set(man.limits(cell)) == {"flow_gap_m", "transform_gap",
                                         "stats_gap", "label_mismatch",
                                         "pairs_diff"}
    for m in OFFLINE:
        assert callable(man.reader(m, True))
    for m in OWN:
        (entry,) = [e for e in man.data["per_layer"] if e["name"] == m]
        assert entry["workloads"] == [WAYMO]


def test_the_configuration_is_the_waymo_preset_at_a_262144_bucket():
    import dataclasses

    from icpflow_tpu_torch import config_from_dict
    from icpflow_tpu_torch.config import WAYMO as PRESET
    man = Manifest()
    conf = man.config(man.cell(WAYMO)["config"])
    assert conf["entry"] == "offline"
    assert conf["reduced"] == [] and conf["changed"] == {}
    assert "max_points_scene" in conf["assumed"]
    assert set(conf["pipeline"]) == \
        {f.name for f in dataclasses.fields(PRESET)}
    assert config_from_dict(conf["pipeline"]) == \
        PRESET.replace(max_points_scene=262144)
    assert "main.sh:3-13" in conf["source"] and "Waymo" in conf["source"]
    (entry,) = [c for c in man.data["configs"] if c["name"] == "waymo_cli"]
    assert entry["source"] == conf["source"] and entry["reduced"] == []


def test_full5_sweeps_fit_262144_and_exceed_131072():
    man = Manifest()
    mix = man.mix(man.cell(WAYMO)["traffic"])
    assert mix["max_points"] == 262144 and mix["sweep_thin"] == 1
    items = man.generator(mix).make(mix, BIG_SEED)
    assert len(items) == mix["samples"]
    for item in items:
        a = item["arrays"]
        sizes = pca_samples.sweep_sizes(a, mix["crop"])
        assert len(sizes) == mix["frames"]
        assert (sizes > 131072).all() and (sizes <= 262144).all()
        # the vehicle frame: the ground rings lie near z = 0
        z = a["raw_points"][:, 2]
        assert abs(float(np.median(z[z < 0.3]))) < 0.2


def test_gap4_pairs_fit_131072_with_an_8_m_window():
    from icpflow_tpu_torch import config_from_dict
    man = Manifest()
    cell = man.cell(GAP4)
    mix = man.mix(cell["traffic"])
    assert (mix["gap"], mix["frames"]) == (4, 5)
    cfg = config_from_dict(man.config(cell["config"])["pipeline"])
    assert cfg.translation_frame(mix["gap"]) == 8.0
    items = man.generator(mix).make(mix, BIG_SEED)
    assert len(items) == mix["scenes"]
    for src, dst in items:
        assert 100_000 < len(src) <= 131072 and 100_000 < len(dst) <= 131072
        # frame 4 against frame 0: the ego moved 4 x 1.1 m between them,
        # so the world-frame clouds differ
        assert not np.array_equal(src[:1000], dst[:1000])


@pytest.mark.parametrize("name", OWN)
def test_the_new_readers_are_silent_without_the_counters(name):
    from icpflow_tpu_torch import trace
    read = Manifest().reader(name, True)
    assert read({}) is None
    assert read({"entry": "pair", "stages": [{}], "calls": 1,
                 "root": "pair"}) is None
    # a traced CPU call that counts no DBSCAN rows and runs nothing on a
    # device: only the ICP span has something to read
    trace.clear()
    with trace.StageClock({}, torch.device("cpu"), "sample"):
        trace.count("icp_iters", 3)
        with trace.span("icpflow.icp"):
            pass
    rec = {"entry": "offline", "root": "sample", "calls": 1,
           "stages": [{"cluster": 1.0}]}
    value = read(rec)
    if name == "icp_ms.offline":
        assert value is not None and value >= 0.0
    else:
        assert value is None
    trace.clear()
    if name == "cluster_fill.offline":
        with trace.StageClock({}, torch.device("cpu"), "sample"):
            trace.count("dbscan_points", 300)
            trace.count("dbscan_slots", 1000)
        assert read(rec) == 0.3
        trace.clear()


def _waymo_small(small_root):
    """The Waymo cell at one sample, every 64th point of a sweep (the small
    root's 4,096 bucket holds it)."""
    path = small_root / "benchmark" / "traffic" / "full5.json"
    mix = json.loads(path.read_text())
    mix.update(samples=1, thin=64)
    path.write_text(json.dumps(mix))
    return small_root


def test_the_waymo_cell_runs_traced_and_reads_its_layers(small_root):
    root = _waymo_small(small_root)
    out = harness.run_cell(WAYMO, BIG_SEED, 0.5, True, "cpu", root=root)
    line = out["line"]
    assert line["correct"] is True, line["check"]
    assert all(c["value"] == 0.0 for c in line["check"].values())
    assert out["record"]["units"] == 4 * out["record"]["calls"]
    # a CPU run reads no device and replays no graph
    assert set(line["metrics"]) == OFFLINE - DEVICE
    fill = line["metrics"]["cluster_fill.offline"]["value"]
    assert 0.25 < fill <= 1.0
    assert line["metrics"]["icp_ms.offline"]["value"] > 0


def test_the_gap4_cell_runs_untraced(small_root):
    out = harness.run_cell(GAP4, 5, 0.5, False, "cpu", root=small_root)
    assert out["line"]["correct"] is True, out["line"]["check"]
    assert set(out["line"]["metrics"]) == {"pairs_per_s", "setup_s"}


@pytest.mark.chip
@pytest.mark.parametrize("cell, seed", [(WAYMO, 3125000101),
                                        (GAP4, 3125100101)])
def test_control_fails_and_program_passes(cuda, cell, seed):
    """On the card, over the mix of the first control seed whose readings
    set the cell's limits (PERF.md): the program within every limit, the
    TF32 control beyond one."""
    from benchmark import control
    limits = Manifest().limits(cell)
    for r in control.readings(cell, [seed], [seed], device=cuda):
        broken = [k for k, v in limits.items() if r["numbers"].get(k, 0) > v]
        assert bool(broken) == (r["side"] == "control"), r
