"""The HDBSCAN cell, ``av2_pairs_hdbscan.dense``: its configuration, its
entry (``entries/pair_hdbscan.py``), the reference's counterpart
(``reference/hdbscan.py``) and its readers, on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import control, harness
from benchmark.entries._shared import EntryBase
from benchmark.manifest import Manifest

CELL = "av2_pairs_hdbscan.dense"
BIG_SEED = 2 ** 31 + 5309
LAYER = {"hdbscan_graph_ms.pair", "hdbscan_tree_ms.pair",
         "hdbscan_rows.pair", "hdbscan_graph_roofline.pair"}


def test_manifest_finds_the_cell_by_name():
    man = Manifest()
    cell = man.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("av2_pairs_hdbscan", "dense", 1)
    conf = man.config(cell["config"])
    assert conf["entry"] == "pair_hdbscan" and conf["reduced"] == []
    assert conf["changed"] == {}
    assert set(man.limits(CELL)) == {"flow_gap_m", "transform_gap",
                                     "stats_gap", "label_mismatch",
                                     "pairs_diff"}
    assert man.limits(CELL)["label_mismatch"] == 0.0
    assert man.limits(CELL)["pairs_diff"] == 0.0
    assert {m["name"] for m in man.metrics(CELL, True)} == LAYER
    assert {m["name"] for m in man.metrics(CELL, False)} == \
        {"pairs_per_s", "setup_s"}
    for m in LAYER:
        assert callable(man.reader(m, True))


def test_the_configuration_is_av2_pairs_with_hdbscan():
    man = Manifest()
    base = man.config("av2_pairs")["pipeline"]
    conf = man.config("av2_pairs_hdbscan")["pipeline"]
    assert conf == dict(base, use_hdbscan=True)


def test_the_entry_keeps_the_contract():
    man = Manifest()
    kind = man.entry("pair_hdbscan")
    assert issubclass(kind, EntryBase)
    assert (kind.unit, kind.root) == ("pair", "pair")
    with pytest.raises(ValueError, match="use_hdbscan"):
        kind(man.config("av2_pairs"), man.mix("dense"), "cpu")


def test_the_entry_refuses_a_weight_only_tree(monkeypatch):
    """The program's clusterer on the JAX package's native tree, which
    sorts the edges by weight alone: the entry refuses it before set-up."""
    import ctypes
    import types

    from icpflow_tpu_torch.data import native_loader
    from icpflow_tpu_torch.ops import hdbscan
    lib = native_loader.get_lib()
    if lib is None:
        pytest.skip("the native library cannot be built here")
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    plain, weighted = lib.ifh_hdbscan_labels, lib.ifh_hdbscan_labels_weighted
    plain.argtypes = [i32p, f32p, ctypes.c_int64, ctypes.c_int32,
                      ctypes.c_int32, i32p]
    weighted.argtypes = [i32p, f32p, i32p, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_int32, i32p]
    shim = types.SimpleNamespace(icpflow_hdbscan_labels=plain,
                                 icpflow_hdbscan_labels_weighted=weighted)
    monkeypatch.setattr(hdbscan, "get_lib", lambda: shim)
    man = Manifest()
    with pytest.raises(RuntimeError, match="tied edges"):
        man.entry("pair_hdbscan")(man.config("av2_pairs_hdbscan"),
                                  man.mix("dense"), "cpu")


def _full_graph(small_root):
    """The small root with two scenes of the dense mix, thinned to every
    64th point, and the cell's representative cap cut to 128, so that the
    clouds take the full graph, as the dense clouds do at full size."""
    path = small_root / "benchmark" / "configs" / "av2_pairs_hdbscan.json"
    conf = json.loads(path.read_text())
    conf["pipeline"]["hdbscan_rep_cap"] = 128
    path.write_text(json.dumps(conf))
    mix_path = small_root / "benchmark" / "traffic" / "dense.json"
    mix = json.loads(mix_path.read_text())
    mix.update(scenes=2, thin=64)
    mix_path.write_text(json.dumps(mix))
    return small_root


def test_entry_and_reference_agree(small_root):
    root = _full_graph(small_root)
    (reading,) = control.readings(CELL, [BIG_SEED], [], device="cpu",
                                  root=root)
    assert reading["outputs"] == 2
    assert all(v == 0.0 for v in reading["numbers"].values()), reading


def test_the_cell_runs_untraced_and_traced(small_root):
    root = _full_graph(small_root)
    plain = harness.run_cell(CELL, 5, 0.5, False, "cpu", root=root)
    traced = harness.run_cell(CELL, 5, 0.5, True, "cpu", root=root)
    for out in (plain, traced):
        assert out["line"]["correct"] is True
        rec = out["record"]
        assert (rec["entry"], rec["unit"], rec["root"]) == \
            ("pair_hdbscan", "pair", "pair")
    assert set(plain["line"]["metrics"]) == {"pairs_per_s", "setup_s"}
    got = traced["line"]["metrics"]
    # the roofline reads the device's profile, which a CPU run lacks
    assert set(got) == LAYER - {"hdbscan_graph_roofline.pair"}
    assert got["hdbscan_graph_ms.pair"]["value"] > 0
    assert got["hdbscan_tree_ms.pair"]["value"] > 0
    assert 1000 <= got["hdbscan_rows.pair"]["value"] <= 2 * 4096


def test_the_readers_read_the_counters_of_a_traced_call():
    """One traced pair on the full graph, under the profiler: the counter
    and the spans the readers read, the bound they divide by, and the
    roofline over the graph's time less the device's idle time in the
    harness span ``hdbscan_graph`` (a profile made up: a CPU has none)."""
    import torch

    from icpflow_tpu_torch import SceneFlowEngine, config_from_dict, pipeline
    from icpflow_tpu_torch import trace

    man = Manifest()
    keys = dict(man.config("av2_pairs_hdbscan")["pipeline"],
                max_points_scene=2048, max_points=512, max_pairs=32,
                pairs_small=32, pairs_large=4, hist_grid_xy=64,
                hdbscan_rep_cap=128)
    cfg = config_from_dict(keys)
    rng = np.random.default_rng(3)
    src = (rng.normal(size=(900, 3)) * [3.0, 3.0, 0.5]).astype(np.float32)
    dst = src + np.float32([0.2, 0.0, 0.0])
    eng = SceneFlowEngine(cfg, device="cpu")
    trace.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        pipeline.run_frame_pair(eng, src, dst, timings={})
    (call,) = trace.calls()
    assert call.profiled and call.counters["hdbscan_rows"] == 1800
    for name in ("icpflow.graph", "icpflow.native", "icpflow.finish"):
        assert name in call.spans
    rec = dict(entry="pair_hdbscan", root="pair", calls=1, stages=[{}])
    assert man.reader("hdbscan_rows.pair", True)(rec) is None  # profiled
    from benchmark.layers import hdbscan_bound
    least = hdbscan_bound.bound_ms(1800)
    assert least == pytest.approx(1800 * 1799 * 10 / 33.5e12 * 1e3)
    spent = call.spans["icpflow.graph"].total_ns * 1e-6
    idle_ms = spent / 4
    rec["profile"] = dict(calls=1, busy_s=1.0,
                          idle_gaps=[["cluster", 9.0],
                                     ["hdbscan_graph", idle_ms * 1e-3]])
    share = man.reader("hdbscan_graph_roofline.pair", True)(rec)
    assert share == pytest.approx(100 * least / (spent - idle_ms))
    # no idle gap in the harness span (it was not opened): nothing to read
    rec["profile"]["idle_gaps"] = [["cluster", 9.0]]
    assert man.reader("hdbscan_graph_roofline.pair", True)(rec) is None
    # an unprofiled call reads the counter
    trace.clear()
    pipeline.run_frame_pair(eng, src, dst, timings={})
    rec.pop("profile")
    assert man.reader("hdbscan_rows.pair", True)(rec) == 1800
    assert man.reader("hdbscan_graph_roofline.pair", True)(rec) is None
    # another entry's record reads nothing
    assert man.reader("hdbscan_rows.pair", True)(
        dict(rec, entry="pair")) is None


def test_the_reference_config_round_trips():
    from benchmark.reference.config import Config
    from benchmark.reference.hdbscan import HdbscanReference
    keys = Manifest().config("av2_pairs_hdbscan")["pipeline"]
    ref = HdbscanReference(dict(vars(Config(keys))), "cpu")
    for k, v in keys.items():
        got = getattr(ref.cfg, k)
        assert (list(got) if isinstance(got, tuple) else got) == v, k


@pytest.mark.chip
def test_control_fails_and_program_passes(cuda):
    """On the card, over the mix of the first control seed whose readings
    set the limits (PERF.md): the program within every limit, the TF32
    control beyond one."""
    limits = Manifest().limits(CELL)
    seeds = [3123000101]
    for r in control.readings(CELL, seeds, seeds, device=cuda):
        broken = [k for k, v in limits.items() if r["numbers"].get(k, 0) > v]
        assert bool(broken) == (r["side"] == "control"), r
