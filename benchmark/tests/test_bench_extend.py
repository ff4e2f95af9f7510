"""A cell, a configuration, a mix and a layer metric are added by adding
files and BENCHMARK.json entries only: no file already there changes."""

from __future__ import annotations

import hashlib
import json

from benchmark import harness


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
