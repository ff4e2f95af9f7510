"""A cell, a configuration, an entry, a mix and a layer metric are added by
adding files and BENCHMARK.json entries only: no file already there
changes."""

from __future__ import annotations

import hashlib
import json

import pytest

from benchmark import control, harness


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_from_new_files(small_root):
    before = _digests(small_root)
    bench_dir = small_root / "benchmark"
    conf = json.loads((bench_dir / "configs" / "av2_pairs.json").read_text())
    conf["pipeline"]["min_cluster_size"] = 10
    (bench_dir / "configs" / "tiny_pairs.json").write_text(json.dumps(conf))
    mix = json.loads((bench_dir / "traffic" / "sparse.json").read_text())
    mix["scenes"] = 2
    (bench_dir / "traffic" / "two_scenes.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "tiny_pairs.two_scenes.json").write_text(
        json.dumps({"limits": {"flow_gap_m": 1e-3}}))
    (bench_dir / "layers" / "flow_ms.pair.py").write_text(
        "from benchmark import readings\n\n\n"
        "def read(rec):\n"
        "    return readings.stage_ms(rec, 'pair', 'flow')\n")
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny_pairs",
                                 file="benchmark/configs/tiny_pairs.json"))
    cell = "tiny_pairs.two_scenes"
    bench["workloads"].append({"name": cell, "config": "tiny_pairs",
                               "traffic": "two_scenes", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("pairs_per_s",):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "flow_ms.pair", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "flow", "moves": "pairs_per_s",
                               "workloads": [cell]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = harness.run_cell(cell, 3, 0.5, False, "cpu", root=small_root)
    traced = harness.run_cell(cell, 3, 0.5, True, "cpu", root=small_root)
    assert set(plain["line"]["metrics"]) == {"pairs_per_s", "setup_s"}
    assert set(traced["line"]["metrics"]) == {"flow_ms.pair"}
    assert plain["line"]["correct"] and traced["line"]["correct"]
    after = _digests(small_root)
    assert all(after[p] == d for p, d in before.items())


# An entry of the test's own: two gap-1 frame pairs a call, each through
# run_frame_pair, under one traced call whose root span is "pair". Its
# output stacks the two pairs' rows, the second pair's labels moved past
# the first's, and its reference does the same to the reference's pairs.
TWO_PAIRS = '''"""Two frame pairs a call through run_frame_pair."""

import contextlib
import itertools

import numpy as np

from benchmark.entries._shared import EntryBase

OFFSET = 1 << 20


def _stack(a, b):
    pairs = [np.asarray(p["pairs"], np.float32).reshape(-1, 10).copy()
             for p in (a, b)]
    pairs[1][:, :2] += OFFSET
    out = dict(pairs=np.concatenate(pairs))
    for k in ("flow", "transforms"):
        out[k] = np.concatenate([a[k], b[k]])
    for k in ("labels_src", "labels_dst"):
        out[k] = np.concatenate([np.asarray(a[k], np.int64),
                                 np.asarray(b[k], np.int64) + OFFSET])
    return out


class Entry(EntryBase):
    unit = "pair"
    root = "pair"

    def __init__(self, conf, mix, device):
        from icpflow_tpu_torch import SceneFlowEngine, config_from_dict
        from icpflow_tpu_torch import pipeline, trace
        self.cfg = config_from_dict(conf["pipeline"])
        self.engine = SceneFlowEngine(self.cfg, device=device)
        self.pipeline, self.trace = pipeline, trace
        self.tf = self.cfg.translation_frame(int(mix["gap"]))

    @staticmethod
    def _twos(items):
        return [(items[k], items[(k + 1) % len(items)])
                for k in range(len(items))]

    def schedule(self, items):
        return itertools.cycle(enumerate(self._twos(items)))

    def warm(self, items):
        for k, item in enumerate(self._twos(items)):
            self.call(k, item, None)

    def units(self, key, item):
        return 2

    def call(self, key, item, timings):
        outs = []
        with self.trace.StageClock(timings, self.engine.device, "pair"):
            for src, dst in item:
                t = None if timings is None else {}
                r = self.pipeline.run_frame_pair(
                    self.engine, src, dst, translation_frame=self.tf,
                    timings=t)
                for k, v in (t or {}).items():
                    timings[k] = timings.get(k, 0.0) + v
                outs.append(dict(flow=r.flow, pairs=r.pairs,
                                 transforms=r.transforms,
                                 labels_src=r.labels_src,
                                 labels_dst=r.labels_dst))
        return _stack(*outs)

    def spans(self):
        return contextlib.nullcontext()

    @staticmethod
    def reference(ref, mix, items, keys):
        tf = ref.cfg.translation_frame(int(mix["gap"]))
        twos = Entry._twos(items)
        return {k: _stack(*(ref.frame_pair(s, d, tf) for s, d in twos[k]))
                for k in sorted(set(keys))}
'''


def test_an_entry_added_from_new_files(small_root):
    """A cell whose entry, configuration, mix, limits and layer reader are
    all new files: it runs untraced and traced, counts its rate in the
    entry's units, reads the program's spans under the entry's root, and
    serves the control's readings."""
    before = _digests(small_root)
    bench_dir = small_root / "benchmark"
    (bench_dir / "entries" / "two_pairs.py").write_text(TWO_PAIRS)
    conf = json.loads((bench_dir / "configs" / "av2_pairs.json").read_text())
    conf["entry"] = "two_pairs"
    (bench_dir / "configs" / "two_pairs.json").write_text(json.dumps(conf))
    mix = json.loads((bench_dir / "traffic" / "sparse.json").read_text())
    mix["scenes"] = 2
    (bench_dir / "traffic" / "two_scenes.json").write_text(json.dumps(mix))
    cell = "two_pairs.two_scenes"
    limits = json.loads(
        (bench_dir / "limits" / "av2_pairs.sparse.json").read_text())
    (bench_dir / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (bench_dir / "layers" / "icp_ms.two_pairs.py").write_text(
        "from benchmark import program_spans\n\n\n"
        "def read(rec):\n"
        "    return program_spans.span_ms(rec, 'two_pairs', 'icpflow.icp')\n")
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="two_pairs",
                                 file="benchmark/configs/two_pairs.json"))
    bench["workloads"].append({"name": cell, "config": "two_pairs",
                               "traffic": "two_scenes", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "icp_ms.two_pairs", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "ops.icp: ICP", "moves": "pairs_per_s",
                               "workloads": [cell]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = harness.run_cell(cell, 2 ** 31 + 21, 0.5, False, "cpu",
                             root=small_root)
    traced = harness.run_cell(cell, 2 ** 31 + 21, 0.5, True, "cpu",
                              root=small_root)
    assert plain["line"]["correct"] and traced["line"]["correct"]
    rec = plain["record"]
    assert (rec["unit"], rec["root"]) == ("pair", "pair")
    assert rec["units"] == 2 * rec["calls"] == 2 * plain["line"]["attempted"]
    metrics = plain["line"]["metrics"]
    assert set(metrics) == {"pairs_per_s", "setup_s"}
    assert metrics["pairs_per_s"]["value"] == pytest.approx(
        2 * rec["calls"] / rec["window_s"])
    assert set(traced["line"]["metrics"]) == {"icp_ms.two_pairs"}
    assert traced["line"]["metrics"]["icp_ms.two_pairs"]["value"] > 0

    readings = list(control.readings(cell, [5], [], device="cpu",
                                     root=small_root))
    assert [(r["side"], r["seed"], r["outputs"]) for r in readings] == \
        [("program", 5, 2)]
    assert all(readings[0]["numbers"].get(k, 0.0) <= v
               for k, v in limits["limits"].items())
    after = _digests(small_root)
    assert all(after[p] == d for p, d in before.items())
