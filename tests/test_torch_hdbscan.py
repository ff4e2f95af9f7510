"""The port's hdbscan clusterer against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages. On the
CPU the port runs plain PyTorch; the JAX package runs XLA:CPU. Tolerances:

* voxel binning (``voxel_dedup_compact``, DBSCAN cells): identical. Both
  bin by a multiply with the fp32 reciprocal of the cell size, as XLA
  compiles the reference's division by a constant;
* exact kNN graph: core distances and edge weights within 1e-5 m, edge
  indices identical. The expanded-form d2 rounds differently in the two
  K = 3 products (XLA's dot, the port's three rounded multiplies), by
  ~ulp(|x|^2); the scenes stay within a few metres of the origin, where
  that is far below the gaps between neighbours;
* voxel-hash graph: core and weights within 1e-5 m, indices identical
  (direct differences, no expanded form);
* labels: identical, with the JAX package's hdbscan handed the port's
  tree (``csrc/hdbscan_tree.cc``, fixture ``jax_on_the_port_tree``). The
  JAX package's own tree (``native/npz_reader.cc``) sorts the edges by
  weight alone, so tied weights enter its spanning tree in an order
  ``std::sort`` leaves unspecified; the port's sorts by (weight, source
  row, destination). Handed the same tree, the two see the same edges in
  the same order;
* ``hdbscan_fetch_f16``: the f16 weights bit-equal to numpy's rounding.

``use_hdbscan`` through the entry points is held against the JAX package in
``test_torch_streaming.py`` (the frame pair and the stream, where the JAX
matcher is compiled once for both), ``test_torch_data.py``
(``DatasetPCA.cluster_pairs``) and ``test_torch_cli.py`` (``cli.run
--if_hdbscan``), within the 0.005 m band of end-to-end flow parity.
"""

import dataclasses
import math
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import icpflow_tpu as J  # noqa: E402
from icpflow_tpu.ops import cluster as jcl  # noqa: E402
from icpflow_tpu.data import native_loader as jnl  # noqa: E402
from icpflow_tpu.ops import hdbscan as jhd  # noqa: E402

import icpflow_tpu_torch as T  # noqa: E402
from icpflow_tpu_torch.data.native_loader import get_lib  # noqa: E402
from icpflow_tpu_torch.ops import cluster as tcl  # noqa: E402
from icpflow_tpu_torch.ops import hdbscan as thd  # noqa: E402
from icpflow_tpu_torch.ops import hdbscan_tree  # noqa: E402

from test_hdbscan import blob  # noqa: E402

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")

torch.set_num_threads(2)
ATOL = 1e-5
EPE_BAND = 0.005
# small representative bucket: the JAX package's exact graph sweeps every
# slot of it on the CPU
JCFG = J.DEMO.replace(min_cluster_size=10, num_clusters=50,
                      hdbscan_rep_cap=2048)


@pytest.fixture
def jax_on_the_port_tree(monkeypatch):
    """The JAX package's hdbscan with the port's tree under the names of
    its native library's entries (the same arguments)."""
    lib = hdbscan_tree.get_lib()
    assert lib is not None
    shim = types.SimpleNamespace(
        ifh_hdbscan_labels=lib.icpflow_hdbscan_labels,
        ifh_hdbscan_labels_weighted=lib.icpflow_hdbscan_labels_weighted)
    monkeypatch.setattr(jnl, "get_lib", lambda *a, **k: shim)


def _tcfg(jcfg):
    return T.config_from_dict(dataclasses.asdict(jcfg))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------ voxel binning (repair)
def _boundary_scene():
    """399 pairs of points: x on the 0.15 m grid, k * 0.15, and 1 mm above
    it. Binned by a true division, some grid values fall one voxel low."""
    x = (np.arange(1, 400) * np.float32(0.15)).astype(np.float32)
    pts = np.full((2 * len(x), 3), 0.05, np.float32)
    pts[0::2, 0] = x
    pts[1::2, 0] = x + np.float32(0.001)
    return pts, np.ones(len(pts), bool)


def test_voxel_dedup_bins_boundary_points_as_jax():
    pts, valid = _boundary_scene()
    jx, jv, jm, jpr, jnu = map(np.asarray, jcl.voxel_dedup_compact(
        *_j(pts, valid), voxel=0.15, cap=1024))
    tx, tv, tm, tpr, tnu = tcl.voxel_dedup_compact(
        *_t(pts, valid), voxel=0.15, cap=1024)
    assert int(jnu) == tnu == 399
    assert (jm[:399] == 2).all()
    np.testing.assert_array_equal(tx.numpy(), jx)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tpr.numpy(), jpr)


@pytest.mark.parametrize("size", [0.8, 0.6 / math.sqrt(3.0)],
                         ids=["eps_max", "eps_over_sqrt3"])
def test_dbscan_cells_bin_boundary_points_as_jax(size):
    """DBSCAN's cells of side ``eps_max`` (adaptive mode) and its
    contraction cells of side eps / sqrt(3), on points at k * size and just
    off it, against the reference's jitted ``floor(xyz / size)``; at
    ``eps_max`` also the sort order that the reference's dbscan returns."""
    rng = np.random.default_rng(0)
    k = np.arange(-300, 300)
    grid = (k * np.float32(size)).astype(np.float32)
    pts = np.stack([grid, np.roll(grid, 7), np.roll(grid, 90)], 1)
    pts = np.concatenate([pts, pts + rng.normal(scale=1e-4, size=pts.shape)
                          .astype(np.float32)])
    valid = np.ones(len(pts), bool)
    jcell = np.asarray(jax.jit(
        lambda x: jnp.floor(x / size).astype(jnp.int32))(jnp.asarray(pts)))
    cc, span = tcl._cells(*_t(pts, valid), size, pad=1)
    np.testing.assert_array_equal(cc.numpy() - 1 + jcell.min(0), jcell)
    if size == 0.8:
        _, _, order = jcl.dbscan(*_j(pts, valid), eps=0.6, min_points=5,
                                 eps_scale_per_m=0.012, eps_max=0.8,
                                 debug_edges=True)
        ids = tcl._flat_id(cc, span)
        np.testing.assert_array_equal(
            torch.sort(ids, stable=True).indices.numpy(), np.asarray(order))


# ----------------------------------------------------- exact kNN graph
def _graph_scene(seed=9, n=500):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.random(n) < 0.1] = False
    mult = rng.integers(1, 5, n).astype(np.int32)
    return pts, valid, mult


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "mult"])
def test_exact_graph_matches_jax(weighted):
    pts, valid, mult = _graph_scene()
    m = mult if weighted else None
    jc, je, jw = map(np.asarray, jcl.exact_knn_mutual_reachability(
        jnp.asarray(pts), jnp.asarray(valid),
        None if m is None else jnp.asarray(m), k=7, src_tile=128,
        dst_tile=256))
    tc, te, tw = tcl.exact_knn_mutual_reachability(
        *_t(pts, valid), None if m is None else torch.as_tensor(m), k=7)
    assert te.dtype == torch.int32
    np.testing.assert_allclose(tc.numpy(), jc, atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), jw, atol=ATOL)
    np.testing.assert_array_equal(te.numpy(), je)
    assert (te.numpy()[~valid] == len(pts)).all()


def _tie_scene():
    """A 6x6x6 lattice of 0.5 m spacing: every inner point has six
    neighbours at exactly the same distance, so the k-th and (k+1)-th d2
    are equal and the lowest index must win."""
    g = np.arange(6, dtype=np.float32) * np.float32(0.5)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return pts, np.ones(len(pts), bool)


def test_exact_graph_ties_and_blocks():
    pts, valid = _tie_scene()
    jc, je, jw = map(np.asarray, jcl.exact_knn_mutual_reachability(
        *_j(pts, valid), k=4, src_tile=64, dst_tile=128))
    outs = []
    for block in (1 << 26, 700):      # one block; blocks of 3 rows
        info = {}
        outs.append(tcl.exact_knn_mutual_reachability(
            *_t(pts, valid), k=4, block=block, info=info))
        assert info["tie_rows"] > 0
    assert info["blocks"] == -(-len(pts) // (700 // len(pts) or 1))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    tc, te, tw = outs[0]
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_allclose(tw.numpy(), jw, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), jc, atol=ATOL)
    # the lowest index first: lattice point 43 = (1, 1, 1) has neighbours
    # 7, 37, 42, 44, 49, 79 at 0.5 m
    assert te[43].tolist() == [7, 37, 42, 44]


def test_knn_recall_changes_nothing():
    pts, valid, mult = _graph_scene(seed=3)
    exact = tcl.exact_knn_mutual_reachability(*_t(pts, valid, mult), k=7)
    approx = tcl.exact_knn_mutual_reachability(*_t(pts, valid, mult), k=7,
                                               knn_recall=0.95)
    for a, b in zip(exact, approx):
        assert torch.equal(a, b)
    # the reference's approx_min_k is exact on the CPU: same graph
    _, je, jw = map(np.asarray, jcl.exact_knn_mutual_reachability(
        *_j(pts, valid, mult), k=7, knn_recall=0.95))
    np.testing.assert_array_equal(approx[1].numpy(), je)
    np.testing.assert_allclose(approx[2].numpy(), jw, atol=ATOL)


# ---------------------------------------------------- voxel-hash graph
def _edges_core_scene():
    rng = np.random.default_rng(0)
    return blob(rng, [0, 0, 0], 200, 0.1), dict(cell_sizes=(0.8,))


def _multiscale_scene():
    rng = np.random.default_rng(4)
    pts = np.concatenate([blob(rng, [0, 0, 0], 400, 0.08),
                          blob(rng, [40, 0, 0], 60, 1.2)])
    return pts, dict(cell_sizes=(0.35, 1.0, 3.0))


@pytest.mark.parametrize("scene", [_edges_core_scene, _multiscale_scene],
                         ids=["edges_core", "multiscale"])
def test_voxel_hash_graph_matches_jax(scene):
    pts, kw = scene()
    valid = np.ones(len(pts), bool)
    valid[::13] = False
    kw.update(k_core=5, edges_per_point=4, cell_cap=32)
    jc, je, jw = map(np.asarray, jcl.mutual_reachability_edges(
        *_j(pts, valid), **kw))
    tc, te, tw = tcl.mutual_reachability_edges(*_t(pts, valid), **kw)
    assert te.dtype == torch.int32
    np.testing.assert_allclose(tc.numpy(), jc, atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), jw, atol=ATOL)
    np.testing.assert_array_equal(te.numpy(), je)


# -------------------------------------------------------------- labels
def _varying_density():
    rng = np.random.default_rng(1)
    return np.concatenate([
        blob(rng, [0, 0, 0], 300, 0.05), blob(rng, [2, 0, 0], 250, 0.05),
        blob(rng, [6, 5, 0], 120, 0.6),
        rng.uniform(-8, 10, size=(60, 3)).astype(np.float32)]), {}


def _sparse_far():
    rng = np.random.default_rng(5)
    return np.concatenate([blob(rng, [0, 0, 0], 500, 0.1),
                           blob(rng, [5, 5, 0], 40, 0.9)]), {}


def _translation():
    rng = np.random.default_rng(10)
    obj = (rng.normal(size=(600, 3)) * [1.0, 0.4, 0.3]).astype(np.float32)
    far = (rng.normal(size=(200, 3)) * 0.5 + [6, 0, 0]).astype(np.float32)
    # the copies differ in size, so that the size ranking has no tie
    return np.concatenate([obj + np.float32([1.3, 2.7, 0.0]),
                           obj[:500] + np.float32([-4.1, -1.9, 0.0]),
                           far]), {}


def _dedup_vs_full(dedup):
    def scene():
        rng = np.random.default_rng(9)
        pts = np.concatenate([
            blob(rng, [0, 0, 0], 400, 0.06), blob(rng, [3, 0, 0], 250, 0.06),
            blob(rng, [5, 4, 0], 150, 0.5),
            rng.uniform(-7, 7, size=(60, 3)).astype(np.float32)])
        return pts, dict(hdbscan_dedup_voxel=0.15 if dedup else 0.0)
    return scene


def _voxel_hash():
    pts, _ = _varying_density()
    return pts, dict(hdbscan_exact=False)


@pytest.mark.parametrize("scene, path", [
    (_varying_density, "dedup"), (_sparse_far, "dedup"),
    (_translation, "dedup"), (_dedup_vs_full(True), "dedup"),
    (_dedup_vs_full(False), "full"), (_voxel_hash, "voxel_hash"),
], ids=["varying_density", "sparse_far", "translation", "dedup", "full",
        "voxel_hash"])
def test_hdbscan_labels_match_jax(scene, path, jax_on_the_port_tree):
    pts, over = scene()
    valid = np.ones(len(pts), bool)
    valid[-7:] = False
    jcfg = JCFG.replace(**over)
    jlab = jhd.hdbscan(*_j(pts, valid), jcfg)
    info = {}
    tlab = thd.hdbscan(*_t(pts, valid), _tcfg(jcfg), info=info, timed=True)
    assert info["path"] == path
    assert set(info["ms"]) >= {"graph", "fetch", "native", "finish"}
    assert tlab.dtype == np.int32
    np.testing.assert_array_equal(tlab, jlab)
    assert (tlab[~valid] == -1).all() and tlab.max() >= 1


def test_overflow_takes_the_full_graph_and_counts(jax_on_the_port_tree):
    rng = np.random.default_rng(10)
    pts = np.concatenate([rng.uniform(-6, 6, size=(300, 3)),
                          blob(rng, [0, 0, 0], 300, 0.1)]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    jcfg = JCFG.replace(hdbscan_rep_cap=64)
    before = thd.DEDUP_OVERFLOWS
    info = {}
    tlab = thd.hdbscan(*_t(pts, valid), _tcfg(jcfg), info=info)
    assert thd.DEDUP_OVERFLOWS == before + 1
    assert info["path"] == "full" and info["n_unique"] > 64
    assert info["ms"] == {}               # stage times only when timed
    np.testing.assert_array_equal(tlab, jhd.hdbscan(*_j(pts, valid), jcfg))


def test_fetch_f16_rounds_like_numpy_and_labels_match_jax(
        jax_on_the_port_tree):
    pts, _ = _varying_density()
    valid = np.ones(len(pts), bool)
    rep = tcl.voxel_dedup_compact(*_t(pts, valid), voxel=0.15, cap=2048)
    _, ed, ew = tcl.exact_knn_mutual_reachability(rep[0], rep[1], rep[2],
                                                  k=10)
    ew[0, 0] = 7.0e4                      # a real edge past the clip
    ced, cew = thd.compress_edges(ed, ew)
    want = np.minimum(ew.numpy(), np.float32(6.0e4)).astype(np.float16)
    assert cew.dtype == torch.float16
    np.testing.assert_array_equal(cew.numpy().view(np.uint16),
                                  want.view(np.uint16))
    hed, hew = thd.expand_edges(ced.numpy(), cew.numpy(), len(ed))
    np.testing.assert_array_equal(hed, np.minimum(ed.numpy(), 65535))
    none = ed.numpy() >= len(ed)
    assert none.any() and (hew[none] == 1e9).all()
    np.testing.assert_array_equal(hew[~none], want[~none].astype(np.float32))
    jcfg = JCFG.replace(hdbscan_fetch_f16=True)
    info = {}
    tlab = thd.hdbscan(*_t(pts, valid), _tcfg(jcfg), info=info)
    assert info["path"] == "dedup"
    np.testing.assert_array_equal(tlab, jhd.hdbscan(*_j(pts, valid), jcfg))
