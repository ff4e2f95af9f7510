"""The readers of the program's own spans and counters
(``program_spans.py`` and the ``layers/`` metrics that use it): on a traced
CPU run, and on hand-made call records."""

from __future__ import annotations

import collections
import json
import sys

import pytest

from benchmark import harness, program_spans
from benchmark.manifest import Manifest

PAIR_SPANS = {"hist_init_ms.pair", "icp_ms.pair", "kabsch_ms.pair",
              "icp_iters.pair", "match_pairs.pair"}
STREAM_SPANS = {"hist_init_ms.stream", "icp_ms.stream", "kabsch_ms.stream",
                "icp_iters.stream", "match_pairs.stream",
                "ego_register_ms.stream", "ego_iters.stream"}
DEVICE_ONLY = {"host_syncs", "nn_kernel_roofline"}


@pytest.mark.parametrize("cell,names,track", [
    ("av2_pairs.sparse", PAIR_SPANS, "track_ms.pair"),
    ("av2_stream.sessions16", STREAM_SPANS, "track_ms.stream")])
def test_a_traced_cpu_run_reports_the_program_spans(small_root, cell, names,
                                                    track):
    out = harness.run_cell(cell, 2 ** 31 + 11, 0.5, True, "cpu",
                           root=small_root)
    metrics = json.loads(json.dumps(out["line"]["metrics"]))
    assert out["line"]["correct"]
    assert names <= set(metrics)
    # a CPU run counts no host sync and times no kernel
    assert not {n for n in metrics if n.split(".")[0] in DEVICE_ONLY}
    m = {n.split(".")[0]: v["value"] for n, v in metrics.items()}
    assert m["icp_iters"] > 0 and m["match_pairs"] > 0
    assert 0 < m["kabsch_ms"] <= m["icp_ms"] + m.get("ego_register_ms", 0)
    assert m["hist_init_ms"] + m["icp_ms"] <= 1.05 * metrics[track]["value"]
    units = {e["name"]: e["unit"]
             for e in Manifest(small_root).data["per_layer"]}
    assert all(metrics[n]["unit"] == units[n] for n in names)


def test_an_untraced_run_reads_nothing(small_root):
    out = harness.run_cell("av2_pairs.sparse", 5, 0.5, False, "cpu",
                           root=small_root)
    rec = out["record"]
    for read in (lambda r: program_spans.span_ms(r, "pair", "icpflow.icp"),
                 lambda r: program_spans.counter(r, "pair", "icp_iters"),
                 lambda r: program_spans.host_syncs(r, "pair"),
                 lambda r: program_spans.nn_roofline(r, "pair")):
        assert read(rec) is None


def _record(entry, profiled=False, device="cuda", spans=None, counters=None,
            syncs=None):
    stats = {}
    for name, total in (spans or {}).items():
        stats[name] = type("S", (), dict(count=1, total_ns=total,
                                         self_ns=total))()
    return type("R", (), dict(
        entry=entry, profiled=profiled, device=device, spans=stats,
        counters=collections.Counter(counters or {}),
        syncs=collections.Counter(syncs or {})))()


@pytest.fixture
def fake_calls(monkeypatch):
    from icpflow_tpu_torch import trace
    kept = []
    monkeypatch.setattr(trace, "calls", lambda: list(kept))
    return kept


def test_means_are_over_the_windows_unprofiled_calls(fake_calls):
    fake_calls += [
        _record("pair", spans={"icpflow.icp": 9e9}),        # before the window
        _record("pair", spans={"icpflow.icp": 2e6, "icpflow.kabsch": 1e6},
                counters={"icp_iters": 30}, syncs={"icpflow.icp": 10}),
        _record("pair", profiled=True, spans={"icpflow.icp": 7e9},
                counters={"icp_iters": 999}),
        _record("pair", spans={"icpflow.icp": 4e6},
                counters={"icp_iters": 10},
                syncs={"icpflow.icp": 4, "icpflow.pair": 6})]
    rec = dict(entry="pair", calls=3, stages=[{}, {}])
    assert program_spans.span_ms(rec, "pair", "icpflow.icp") == \
        pytest.approx(3.0)
    assert program_spans.span_ms(rec, "pair", "icpflow.kabsch") == \
        pytest.approx(0.5)                  # a call without it counts 0
    assert program_spans.counter(rec, "pair", "icp_iters") == 20
    assert program_spans.counter(rec, "pair", "ego_iters") == 0
    assert program_spans.host_syncs(rec, "pair") == 10
    assert program_spans.span_ms(rec, "stream", "icpflow.icp") is None
    assert program_spans.span_ms(dict(rec, stages=[]), "pair",
                                 "icpflow.icp") is None
    fake_calls[-1].device = "cpu"
    assert program_spans.host_syncs(rec, "pair") is None


def test_stream_calls_are_the_frames(fake_calls):
    fake_calls += [_record("pair", spans={"icpflow.icp": 1e6}),
                   _record("frame", spans={"icpflow.icp": 3e6})]
    rec = dict(entry="stream", calls=2, stages=[{}])
    assert program_spans.span_ms(rec, "stream", "icpflow.icp") == 3.0


def test_nn_roofline_reads_the_profiled_calls(fake_calls):
    nb = program_spans._nn_bound()
    fake_calls += [
        _record("pair", counters={"nn_valid.expanded.index": 5e8}),
        _record("pair", profiled=True,
                counters={"nn_valid.expanded.index": 1e9,
                          "nn_valid.elementwise.points": 2e9,
                          "icp_iters": 40}),
        _record("pair", profiled=True,
                counters={"nn_valid.sentinel.points": 1e9})]
    prof = dict(calls=2, busy_s=0.5, window_s=2.0, nn_kernel_s=0.004)
    rec = dict(entry="pair", calls=3, stages=[{}], profile=prof)
    bound = (nb.bound_ms(1e9, "expanded", False)
             + nb.bound_ms(2e9, "elementwise", True)
             + nb.bound_ms(1e9, "sentinel", True))
    assert program_spans.nn_roofline(rec, "pair") == \
        pytest.approx(100 * bound / 4.0)
    # the profile and the program must agree on the calls profiled
    assert program_spans.nn_roofline(
        dict(rec, profile=dict(prof, calls=3)), "pair") is None
    assert program_spans.nn_roofline(dict(rec, profile=None), "pair") is None


def test_a_program_without_a_trace_reads_nothing(monkeypatch, fake_calls):
    """As the parent program reads, which has no trace module."""
    import icpflow_tpu_torch
    fake_calls.append(_record("pair", spans={"icpflow.icp": 1e6}))
    monkeypatch.delattr(icpflow_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "icpflow_tpu_torch.trace", None)
    rec = dict(entry="pair", calls=3, stages=[{}],
               profile=dict(calls=2, busy_s=0.5, window_s=2.0,
                            nn_kernel_s=0.004))
    assert program_spans.span_ms(rec, "pair", "icpflow.icp") is None
    assert program_spans.counter(rec, "pair", "icp_iters") is None
    assert program_spans.host_syncs(rec, "pair") is None
    assert program_spans.nn_roofline(rec, "pair") is None


def test_every_new_metric_has_a_reader_and_reads_none_of_an_empty_record():
    man = Manifest()
    names = [m["name"] for m in man.data["per_layer"]
             if m["source"] == "program_span"
             or m["name"].startswith("nn_kernel_roofline")]
    assert len(names) >= 16
    for name in names:
        assert man.reader(name, True)(dict(entry="pair", calls=0,
                                           stages=[])) is None
