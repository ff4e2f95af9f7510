"""The port's hdbscan against the benchmark's plain reference
(``benchmark/reference/hdbscan.py``), on the CPU, without JAX.

* The reference's tree against the port's (``csrc/hdbscan_tree.cc``),
  weighted and not, on graphs whose weights are rounded to 0.1 m so that
  ties are dense: the same labels, because both take the edges in the
  order (weight, source row, destination).
* That order makes the port's tree a function of its edge set: shuffling
  the slots of every row moves no label (a weight-only sort moved some).
* ``ops/hdbscan.hdbscan`` against the reference's ``hdbscan`` on the
  ``dedup`` and the ``full`` graph: the same labels.
* ``run_frame_pair`` with ``use_hdbscan`` against
  ``HdbscanReference.frame_pair`` on a thinned pair of the dense mix, held
  to the limits of the cell ``av2_pairs_hdbscan.dense``.
* ``ops/hdbscan_tree`` compiles the tree once for each source: an edited
  source gets a library of its own, a current one is loaded as it is.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import hdbscan as ref_hdbscan
from benchmark.traffic import scenes
from icpflow_tpu_torch import SceneFlowEngine, config_from_dict, pipeline
from icpflow_tpu_torch.config import DEMO
from icpflow_tpu_torch.ops import cluster as tcl
from icpflow_tpu_torch.ops import hdbscan as thd
from icpflow_tpu_torch.ops import hdbscan_tree

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
CELL = "av2_pairs_hdbscan.dense"
SMALL = dict(max_points_scene=4096, max_points=512, max_pairs=32,
             pairs_small=32, pairs_large=4, hist_grid_xy=64)
THIN = 32

needs_lib = pytest.mark.skipif(hdbscan_tree.get_lib() is None,
                               reason="the tree library cannot be built")


def _blobs(seed: int, scale: float = 1.0):
    """Three blobs of different density and scattered noise; the last 9
    points invalid."""
    rng = np.random.default_rng(seed)

    def blob(center, n, s):
        return (np.asarray(center) + rng.normal(scale=s * scale,
                                                size=(n, 3))
                ).astype(np.float32)
    pts = np.concatenate([blob([0, 0, 0], 600, 0.3),
                          blob([3, 0, 0], 400, 0.2),
                          blob([5, 4, 0], 300, 0.8),
                          rng.uniform(-8, 8, (120, 3)).astype(np.float32)])
    valid = np.ones(len(pts), bool)
    valid[-9:] = False
    return pts, valid, rng


def _quantised_graph(seed: int, weighted: bool):
    """(edge_dst, edge_w, node_w) numpy: the exact kNN graph of a seeded
    cloud, k = 10, its weights rounded to 0.1 m (no edge stays 1e9)."""
    pts, valid, rng = _blobs(seed)
    mult = rng.integers(1, 5, len(pts)) if weighted else None
    _, ed, ew = tcl.exact_knn_mutual_reachability(
        torch.as_tensor(pts), torch.as_tensor(valid),
        None if mult is None else torch.as_tensor(mult), k=10)
    ew = torch.where(ew < 1e8, torch.round(ew * 10) / 10, ew)
    return (ed.numpy(), ew.numpy(),
            None if mult is None else mult.astype(np.int32))


GRAPHS = [(seed, weighted) for seed in (0, 1, 2) for weighted in (False, True)]
GRAPH_IDS = [f"seed{s}-{'weighted' if w else 'unweighted'}"
             for s, w in GRAPHS]


@needs_lib
@pytest.mark.parametrize("seed, weighted", GRAPHS, ids=GRAPH_IDS)
def test_reference_tree_equals_the_native_tree(seed, weighted):
    ed, ew, nw = _quantised_graph(seed, weighted)
    # dense ties: far fewer distinct weights than edges
    real = ew[ew < 1e8]
    assert len(np.unique(real)) * 20 < len(real)
    native = thd._native_labels(ed, ew, 10, node_w=nw)
    ref = ref_hdbscan.tree_labels(torch.as_tensor(ed), torch.as_tensor(ew),
                                  10, nw)
    assert native.max() >= 2
    np.testing.assert_array_equal(ref, native)


@needs_lib
@pytest.mark.parametrize("seed, weighted", GRAPHS, ids=GRAPH_IDS)
def test_shuffled_slots_move_no_native_label(seed, weighted):
    ed, ew, nw = _quantised_graph(seed, weighted)
    rng = np.random.default_rng(seed + 100)
    perm = np.argsort(rng.random(ed.shape), axis=1)[:, ::-1]
    ed_p = np.take_along_axis(ed, perm, 1)
    ew_p = np.take_along_axis(ew, perm, 1)
    native = thd._native_labels(ed, ew, 10, node_w=nw)
    np.testing.assert_array_equal(
        thd._native_labels(ed_p, ew_p, 10, node_w=nw), native)
    np.testing.assert_array_equal(
        ref_hdbscan.tree_labels(torch.as_tensor(ed_p), torch.as_tensor(ew_p),
                                10, nw), native)


def test_spanning_forest_is_kruskals():
    """Boruvka over distinct ranks picks the edges Kruskal's scan unites,
    on a graph of several components with parallel edges."""
    rng = np.random.default_rng(5)
    n = 300
    a = rng.integers(0, n, 2000)
    b = rng.integers(0, n, 2000)
    keep = (a != b) & ((a < 140) == (b < 140))      # two halves apart
    a, b = a[keep], b[keep]
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x
    want = []
    for r, (u, v) in enumerate(zip(a, b)):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            want.append(r)
    got = ref_hdbscan.spanning_forest(n, torch.as_tensor(a),
                                      torch.as_tensor(b))
    assert got.tolist() == want


def _cfg(**over):
    return DEMO.replace(min_cluster_size=10, num_clusters=50,
                        use_hdbscan=True, **over)


@needs_lib
@pytest.mark.parametrize("seed", [0, 3, 4])
@pytest.mark.parametrize("path", ["dedup", "full"])
def test_port_hdbscan_equals_the_reference(seed, path):
    pts, valid, _ = _blobs(seed, scale=0.5)
    cfg = _cfg(hdbscan_rep_cap=2048 if path == "dedup" else 64)
    x, v = torch.as_tensor(pts), torch.as_tensor(valid)
    info, rinfo = {}, {}
    lab = thd.hdbscan(x, v, cfg, info=info)
    ref = ref_hdbscan.hdbscan(x, v, cfg, info=rinfo)
    assert info["path"] == rinfo["path"] == path
    assert lab.max() >= 2
    np.testing.assert_array_equal(lab, ref)


def _dense_pair(seed: int):
    """One thinned pair of the dense mix (every ``THIN``-th point)."""
    mix = json.loads((REPO / "benchmark" / "traffic" / "dense.json")
                     .read_text())
    mix.update(scenes=1, thin=THIN, max_points=SMALL["max_points_scene"])
    return scenes.make(mix, seed)[0], mix


@needs_lib
@pytest.mark.parametrize("path", ["dedup", "full"])
def test_frame_pair_equals_the_reference_within_the_cells_limits(path):
    conf = json.loads((REPO / "benchmark" / "configs"
                       / "av2_pairs_hdbscan.json").read_text())
    keys = dict(conf["pipeline"], **SMALL)
    if path == "full":
        keys["hdbscan_rep_cap"] = 256
    cfg = config_from_dict(keys)
    assert cfg.use_hdbscan
    (src, dst), mix = _dense_pair(2 ** 33 + 17)
    eng = SceneFlowEngine(cfg, device="cpu")
    tf = cfg.translation_frame(int(mix["gap"]))
    r = pipeline.run_frame_pair(eng, src, dst, translation_frame=tf)
    assert eng.cluster_info["path"] == path
    ref = ref_hdbscan.HdbscanReference(dataclasses.asdict(cfg), "cpu")
    want = ref.frame_pair(src, dst, tf)
    got = dict(flow=r.flow, pairs=r.pairs, transforms=r.transforms,
               labels_src=r.labels_src, labels_dst=r.labels_dst)
    assert len(r.pairs) > 0 and r.labels_src.max() >= 2
    limits = json.loads((REPO / "benchmark" / "limits" / f"{CELL}.json")
                        .read_text())["limits"]
    numbers = check.compare(got, want)
    assert set(limits) <= set(numbers)
    for name, limit in limits.items():
        assert numbers[name] <= limit, (name, numbers[name], limit)
    assert numbers["label_mismatch"] == 0 and numbers["pairs_diff"] == 0


# ------------------------------------------- the tree library's build
@pytest.mark.parametrize("state, builds", [
    ("missing", 1), ("current", 1), ("edited", 2)])
def test_the_tree_library_is_built_once_for_each_source(
        tmp_path, monkeypatch, state, builds):
    """A library is compiled where none matches the source; a current one
    is loaded as it is; an edited source gets a library of its own."""
    src = tmp_path / "hdbscan_tree.cc"
    src.write_text("// source")
    made = []

    def run(cmd, **kw):
        if cmd[-1] == "--version":
            return types.SimpleNamespace(returncode=0, stdout="c++ 1\n",
                                         stderr="")
        made.append(cmd)
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_text("library")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(hdbscan_tree, "SOURCE", src)
    monkeypatch.setattr(hdbscan_tree, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hdbscan_tree, "compiler", lambda: "c++")
    monkeypatch.setattr(hdbscan_tree.subprocess, "run", run)
    monkeypatch.setattr(hdbscan_tree.ctypes, "CDLL",
                        lambda path: types.SimpleNamespace(
                            path=path, icpflow_hdbscan_labels=_Fn(),
                            icpflow_hdbscan_labels_weighted=_Fn()))

    def load():
        monkeypatch.setattr(hdbscan_tree, "_lib", None)
        monkeypatch.setattr(hdbscan_tree, "_tried", False)
        lib = hdbscan_tree.get_lib()
        assert lib is not None
        assert hdbscan_tree.get_lib() is lib         # once a process
        return lib.path

    paths = [load()]
    if state != "missing":
        if state == "edited":
            src.write_text("// source, edited")
        paths.append(load())
    assert len(made) == builds
    assert len(set(paths)) == builds
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        {pathlib.Path(p).name for p in paths})


class _Fn:
    """Stands in for a bound entry of the library."""
    restype = argtypes = None
