"""The offline nuScenes cell, ``nuscenes_cli.multigap``: its generator
(``traffic/pca_samples.py``), its entry (``entries/offline.py``) and the
reference's counterpart (``reference/offline.py``), on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import check, control, harness
from benchmark.entries._shared import EntryBase
from benchmark.manifest import Manifest
from benchmark.traffic import pca_samples

CELL = "nuscenes_cli.multigap"
BIG_SEED = 2 ** 31 + 4321
LAYER = {"load_ms.offline", "ground_ms.offline", "cluster_ms.offline",
         "track_ms.offline", "hist_init_ms.offline", "icp_iters.offline",
         "score_ms.offline", "device_idle_share.offline",
         "nn_kernel_roofline.offline"}


def _mix():
    man = Manifest()
    return man.mix(man.cell(CELL)["traffic"])


def test_manifest_finds_the_cell_by_name():
    man = Manifest()
    cell = man.cell(CELL)
    conf = man.config(cell["config"])
    assert conf["entry"] == "offline" and conf["reduced"] == []
    assert conf["pipeline"]["dataset"] == "nuscene"
    assert conf["pipeline"]["num_frames"] == 11
    assert conf["pipeline"]["use_kiss_icp"] is False
    mix = man.mix(cell["traffic"])
    assert man.generator(mix).make.__module__ == "bench_traffic_pca_samples"
    assert set(man.limits(CELL)) == {"flow_gap_m", "transform_gap",
                                     "stats_gap", "label_mismatch",
                                     "pairs_diff"}
    assert {m["name"] for m in man.metrics(CELL, True)} == LAYER
    assert {m["name"] for m in man.metrics(CELL, False)} == \
        {"pairs_per_s", "setup_s"}
    for m in LAYER:
        assert callable(man.reader(m, True))


def test_the_preset_is_the_ports_nuscenes_preset():
    import dataclasses

    from icpflow_tpu_torch import config_from_dict
    from icpflow_tpu_torch.config import NUSCENES
    conf = Manifest().config("nuscenes_cli")
    assert config_from_dict(conf["pipeline"]) == NUSCENES
    assert set(conf["pipeline"]) == \
        {f.name for f in dataclasses.fields(NUSCENES)}


def test_the_entry_keeps_the_contract():
    man = Manifest()
    kind = man.entry("offline")
    assert issubclass(kind, EntryBase)
    assert (kind.unit, kind.root) == ("pair", "sample")
    entry = kind(man.config("nuscenes_cli"), _mix(), "cpu")
    assert entry.units(0, None) == 10


def test_same_seed_same_samples_and_the_sweeps_fit():
    mix = _mix()
    streams = np.random.SeedSequence(BIG_SEED).spawn(2)
    a = pca_samples.sample(streams[1], mix["frames"], mix["hz"],
                           mix["sweep_thin"], mix["extra"], 0)
    b = pca_samples.sample(np.random.SeedSequence(BIG_SEED).spawn(2)[1],
                           mix["frames"], mix["hz"], mix["sweep_thin"],
                           mix["extra"], 0)
    assert set(a) == {"raw_points", "time_indice", "sd_labels",
                      "fb_labels", "inst_labels", "ego_motion_gt",
                      "bbox_tsfm"}
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    sizes = pca_samples.sweep_sizes(a, mix["crop"])
    assert len(sizes) == mix["frames"]
    assert 30_000 <= sizes.min() and sizes.max() <= 40_000
    assert sizes.max() <= mix["max_points"]
    # movers are the dynamic foreground; the ego moves 0.55 m a sweep
    assert np.array_equal(a["sd_labels"], (a["inst_labels"] > 0))
    assert np.array_equal(a["fb_labels"], a["sd_labels"])
    step = np.diff(a["ego_motion_gt"][:, 0, 3])
    assert np.allclose(step, 0.55, atol=1e-6)


def test_every_sample_of_the_mix_fits():
    mix = _mix()
    streams = np.random.SeedSequence(7).spawn(mix["samples"] + 1)[1:]
    for index, ss in enumerate(streams):
        s = pca_samples.sample(ss, mix["frames"], mix["hz"],
                               mix["sweep_thin"], mix["extra"], index)
        sizes = pca_samples.sweep_sizes(s, mix["crop"])
        assert 30_000 <= sizes.min() and sizes.max() <= 40_000


def _three_frames(small_root):
    """The cell at 3 frames a sample and one sample (the small root's
    buckets and thinned mix)."""
    bench = small_root / "benchmark"
    conf_path = bench / "configs" / "nuscenes_cli.json"
    conf = json.loads(conf_path.read_text())
    conf["pipeline"]["num_frames"] = 3
    conf_path.write_text(json.dumps(conf))
    mix_path = bench / "traffic" / "multigap.json"
    mix = json.loads(mix_path.read_text())
    mix.update(frames=3, samples=1)
    mix_path.write_text(json.dumps(mix))
    return small_root


def test_make_writes_what_it_returns(small_root):
    root = _three_frames(small_root)
    man = Manifest(root)
    mix = man.mix("multigap")
    gen = man.generator(mix)
    items = gen.make(mix, BIG_SEED)
    again = gen.make(mix, BIG_SEED)
    assert len(items) == 1 and items[0]["path"] != again[0]["path"]
    assert str(root / "benchmark" / ".cache") in items[0]["path"]
    with np.load(items[0]["path"]) as f:
        for k, v in items[0]["arrays"].items():
            assert np.array_equal(f[k], v) and np.array_equal(
                again[0]["arrays"][k], v), k


def test_entry_and_reference_agree(small_root):
    root = _three_frames(small_root)
    (reading,) = control.readings(CELL, [BIG_SEED], [], device="cpu",
                                  root=root)
    assert reading["outputs"] == 1
    assert all(v == 0.0 for v in reading["numbers"].values()), reading


def test_the_cell_runs_untraced_and_traced(small_root):
    root = _three_frames(small_root)
    plain = harness.run_cell(CELL, 5, 0.5, False, "cpu", root=root)
    traced = harness.run_cell(CELL, 5, 0.5, True, "cpu", root=root)
    for out in (plain, traced):
        assert out["line"]["correct"] is True
        rec = out["record"]
        assert (rec["unit"], rec["root"]) == ("pair", "sample")
        assert rec["units"] == 2 * rec["calls"]
    assert set(plain["line"]["metrics"]) == {"pairs_per_s", "setup_s"}
    # a CPU run reads no device: the two device metrics are left out
    assert set(traced["line"]["metrics"]) == LAYER - {
        "device_idle_share.offline", "nn_kernel_roofline.offline"}
    assert traced["line"]["metrics"]["icp_iters.offline"]["value"] > 0
    assert traced["line"]["metrics"]["score_ms.offline"]["value"] > 0


def test_compare_reads_the_stacked_output():
    from benchmark.entries.offline import OFFSET, stack
    t = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    table = np.zeros((1, 10), np.float32)
    a = stack(np.zeros((5, 3)), [t, t], [table, table],
              [np.array([0, 0, -1]), np.array([1, 1, 1])],
              [np.array([0]), np.array([1])])
    assert a["labels_src"].tolist() == [OFFSET, OFFSET, OFFSET - 1,
                                        2 * OFFSET + 1, 2 * OFFSET + 1,
                                        2 * OFFSET + 1]
    assert a["pairs"][:, :2].tolist() == [[OFFSET, OFFSET],
                                          [2 * OFFSET, 2 * OFFSET]]
    row = check.compare(a, a)
    assert all(v == 0.0 for v in row.values())
    b = dict(a, labels_src=np.where(a["labels_src"] == OFFSET - 1, OFFSET,
                                    a["labels_src"]))
    assert check.compare(b, a)["label_mismatch"] > 0


@pytest.mark.chip
def test_control_fails_and_program_passes(cuda):
    """On the card, over the mix of the first control seed whose readings
    set the limits (PERF.md): the program within every limit, the TF32
    control beyond one."""
    limits = Manifest().limits(CELL)
    seeds = [3190000101]
    for r in control.readings(CELL, seeds, seeds, device=cuda):
        broken = [k for k, v in limits.items() if r["numbers"].get(k, 0) > v]
        assert bool(broken) == (r["side"] == "control"), r
