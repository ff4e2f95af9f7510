"""The metric arithmetic on hand-made inputs."""

from __future__ import annotations

import statistics

import numpy as np
import pytest

from benchmark import check, readings, stats, trace
from benchmark.entries._shared import EntryBase


def test_rate_is_over_the_whole_window():
    assert stats.rate(51, 51.0) == 1.0
    assert stats.rate(10, 4.0) == 2.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentile_over_all_calls_matches_numpy():
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    for q in (0, 50, 90, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile(list(range(1, 11)), 90) == pytest.approx(9.1)


def test_union_counts_overlaps_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([(0, 10), (2, 3)]) == 10
    assert stats.union_length([]) == 0


def test_gaps_are_what_no_interval_covers():
    assert stats.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert stats.gaps([(0, 6)], 0, 6) == []


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10, 11, 12, 13, 14, 15]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == (q3 - q1) / med


def test_trace_reduce_on_a_hand_made_timeline():
    # two calls of 100 ns; device busy 10-30 (one kernel), 40-50 (NN),
    # 120-150 (a copy); spans: cluster 0-35, track 35-90 in call 1
    device = [(10, 30, "void foo<1>(int)"),
              (40, 50, "void masked_nn_kernel<1, false, 2>(float const*)"),
              (120, 150, "Memcpy DtoH (Device -> Pinned)")]
    spans = [(0, 35, "cluster"), (35, 90, "track")]
    calls = [(0, 100), (110, 200)]
    r = trace.reduce(device, spans, calls)
    assert r["calls"] == 2
    assert r["window_s"] == pytest.approx(200e-9)
    assert r["busy_s"] == pytest.approx(60e-9)
    assert r["kernels"] == 2
    assert r["nn_kernel_s"] == pytest.approx(10e-9)
    idle = dict(r["idle_gaps"])
    # gaps split at span and call edges: cluster 0-10, 30-35; track 35-40,
    # 50-90; after_track 90-100; harness 100-110; call 2 has no layer
    # span: entry 110-120 and 150-200
    assert idle["cluster"] == pytest.approx(15e-9)
    assert idle["track"] == pytest.approx(45e-9)
    assert idle["after_track"] == pytest.approx(10e-9)
    assert idle["harness"] == pytest.approx(10e-9)
    assert idle["entry"] == pytest.approx(60e-9)
    assert dict(r["device_ops"])["void foo<1>"] == pytest.approx(20e-9)


def test_readers_take_means_per_call():
    rec = dict(entry="stream", unit="frame", root="frame", calls=2, units=2,
               stages=[{"ego": 10.0, "ground": 5.0},
                       {"ego": 20.0, "ground": 5.0, "track": 60.0}],
               host_ms=[16.0, 90.0])
    assert readings.stage_ms(rec, "stream", "track") == 30.0
    assert readings.stage_ms(rec, "stream", "ego") == 15.0
    assert readings.host_ms(rec, "stream") == pytest.approx(3.0)
    assert readings.stage_ms(rec, "pair", "track") is None
    assert readings.profile(dict(rec, profile=None), "stream") is None
    no_device = dict(calls=2, busy_s=0.0, window_s=1.0)
    assert readings.profile(dict(rec, profile=no_device), "stream") is None


# (record's unit, calls, units): what each end-to-end reader reads
E2E_CASES = [
    ("pairs_per_s", "pair", 10, 10, 2.5),
    ("pairs_per_s", "pair", 10, 20, 5.0),       # units, not calls
    ("pairs_per_s", "frame", 10, 10, None),
    ("frames_per_s", "frame", 10, 10, 2.5),
    ("frames_per_s", "frame", 10, 30, 7.5),
    ("frames_per_s", "pair", 10, 10, None),
    ("frame_ms_p90", "frame", 10, 10, 9.1),
    ("frame_ms_p90", "pair", 10, 10, None),
    ("setup_s", "pair", 10, 10, 12.5),
]


@pytest.mark.parametrize("metric,unit,calls,units,value", E2E_CASES)
def test_end_to_end_readers_read_the_records_unit(metric, unit, calls,
                                                  units, value):
    from benchmark.manifest import Manifest
    rec = dict(entry="any", unit=unit, root=unit, calls=calls, units=units,
               window_s=4.0, latency_ms=[float(x) for x in range(1, 11)],
               setup_s=12.5)
    got = Manifest().reader(metric, False)(rec)
    if value is None:
        assert got is None
    else:
        assert got == pytest.approx(value)


def test_label_mismatch_is_blind_to_renaming():
    a = np.array([0, 0, 1, 1, -1, 2])
    assert check.label_mismatch(a, np.array([5, 5, 3, 3, 9, 0])) == 0.0
    assert check.label_mismatch(a, np.array([5, 5, 5, 3, 9, 0])) == \
        pytest.approx(1 / 6)
    # a merge of two clusters counts, whichever side merged
    merged = np.array([0, 0, 0, 0, -1, 2])
    assert check.label_mismatch(a, merged) == pytest.approx(2 / 6)
    assert check.label_mismatch(merged, a) == pytest.approx(2 / 6)


def _pair_out(flow_shift=0.0):
    flow = np.zeros((4, 3), np.float32)
    flow[1, 0] = flow_shift
    pairs = np.array([[0, 1, .1, .1, .9, .9, 1, 1, .5, .5]], np.float32)
    return dict(flow=flow, pairs=pairs, transforms=np.eye(4)[None],
                labels_src=np.array([0, 0, 1, -1]),
                labels_dst=np.array([0, 1, 1, 1]))


def test_compare_reads_each_number():
    same = check.compare(_pair_out(), _pair_out())
    assert all(v == 0 for v in same.values())
    off = check.compare(_pair_out(0.3), _pair_out())
    assert off["flow_gap_m"] == pytest.approx(0.3)
    other = _pair_out()
    other["pairs"] = np.zeros((0, 10), np.float32)
    assert check.compare(other, _pair_out())["pairs_diff"] == 1
    assert check.compare(None, _pair_out())["flow_gap_m"] >= 1e30
    assert check.compare(None, None)["flow_gap_m"] == 0


def test_judge_counts_each_broken_comparison():
    rows = [{"flow_gap_m": 0.0}, {"flow_gap_m": 0.5}, {"flow_gap_m": 2.0}]
    numbers, failed = check.judge(rows, {"flow_gap_m": 1.0})
    assert numbers == {"flow_gap_m": 2.0} and failed == 1


def test_nn_bound_copy_agrees_with_the_program():
    """The copy of the kernel's bound reads as the program's does today
    (the copy is what a roofline metric will read)."""
    import importlib.util
    from benchmark.manifest import HERE
    spec = importlib.util.spec_from_file_location(
        "nn_bound", HERE / "layers" / "nn_bound.py")
    nb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(nb)
    from icpflow_tpu_torch.ops.cuda import nn_kernel
    for form in nb.FORMS:
        for points in (False, True):
            assert nb.bound_ms(4.29e8, form, points) == \
                nn_kernel.bound_ms(4.29e8, form, points)
    assert nb.io_ms(7, 4096, 4096, True, True) == \
        nn_kernel.io_ms(7, 4096, 4096, True, True)


class _FakeEntry(EntryBase):
    """Calls of 20 ms with one StageClock-like stage."""

    unit = root = "pair"

    def schedule(self, items):
        import itertools
        return itertools.cycle(enumerate(items))

    def call(self, key, item, timings):
        import time
        time.sleep(0.02)
        if timings is not None:
            timings["track"] = 15.0
        return {"key": key}


def test_traced_window_keeps_stages_of_every_unprofiled_call():
    import numpy as np

    from benchmark import harness
    record, outs = harness._window(_FakeEntry(), [0, 1], 0.5, True, "cpu",
                                   np.random.default_rng(3))
    assert record["calls"] == len(record["latency_ms"]) == record["units"]
    assert len(record["stages"]) == record["calls"] - harness.PROFILED_CALLS
    assert len(record["host_ms"]) == len(record["stages"])
    assert record["profile"]["calls"] == harness.PROFILED_CALLS


def test_window_keeps_every_item_once_and_a_seeded_sample():
    """The first output of every item, then a sample drawn from the seed:
    the same seed keeps the same calls."""
    import numpy as np

    from benchmark import harness

    def kept(seed):
        record, outs = harness._window(_FakeEntry(), [0, 1, 2], 0.6, False,
                                       "cpu", np.random.default_rng(seed))
        return record["calls"], [o["key"] for _, o in outs]

    calls, keys = kept(5)
    assert keys[:3] == [0, 1, 2]
    assert len(keys) < calls
    assert set(keys) == {0, 1, 2}
