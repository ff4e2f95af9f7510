"""hdbscan's exact kNN graph on the card (``csrc/knn_graph.cu``,
``ops/cuda/knn_graph.py``) and the split of ``cluster._knn_graph`` around
it.

On the CPU: a numpy float32 model of the kernel (its order of operations:
three rounded multiplies of the row pre-scaled by the exact -2, two
rounded adds; the home window's bound T; a running (d2, column) top-(k+1)
over every column; the tie count) equals
``_knn_graph_plain`` bit for bit; the wrapper refuses what the kernel does
not take; a CPU call takes the plain version. No JAX at import: the one
case that needs a GPU runs on the card with ``python3 -m pytest
tests/test_torch_knn_graph_kernel.py --noconftest -o addopts="" -p
no:cacheprovider -k gpu``.
"""

import bisect

import numpy as np
import pytest
import torch

from icpflow_tpu_torch import trace
from icpflow_tpu_torch.ops import cluster
from icpflow_tpu_torch.ops.cuda import knn_graph as cuda_knn

BIG = np.float32(1e9)
NONE = 2 ** 31 - 1          # csrc: kNone, the column of an empty slot
SEED_PAD = 384              # csrc: kSeedPad
BLOCK = 1 << 26


def _d2(q, qsq, r0, r1, c0, c1):
    """The kernel's d2 of rows [r0, r1) and columns [c0, c1), float32:
    ((p0 q0 + p1 q1) + p2 q2) + psq, then + qsq, p = -2 q, self at 1e9."""
    p = q[r0:r1] * np.float32(-2.0)
    c = q[c0:c1]
    s = p[:, None, 0] * c[None, :, 0] + p[:, None, 1] * c[None, :, 1]
    s = s + p[:, None, 2] * c[None, :, 2]
    d = (s + qsq[r0:r1, None]) + qsq[None, c0:c1]
    assert d.dtype == np.float32
    rows = np.arange(r0, r1)
    own = (rows >= c0) & (rows < c1)
    d[np.flatnonzero(own), rows[own] - c0] = BIG
    return d


def _running(init, d, c0):
    """A running top-len(init) of (d2, column), columns from ``c0`` in
    ascending order, as the kernel's list takes them."""
    lst = list(init)
    for i in np.flatnonzero(d <= lst[-1][0]):
        cand = (float(d[i]), c0 + int(i))
        if cand < lst[-1]:
            bisect.insort(lst, cand)
            lst.pop()
    return lst


def kernel_model(q, qsq, k):
    """What ``knn_graph`` computes, in its order, in numpy float32: vals
    (m, k) float32, cols (m, k) int64 (m where none) and the tie rows."""
    m = len(q)
    k1 = k + 1
    rows_a_block = cuda_knn.BLOCK_ROWS
    vals = np.full((m, k), BIG, np.float32)
    cols = np.full((m, k), m, np.int64)
    ties = 0
    for r0 in range(0, m, rows_a_block):
        r1 = min(m, r0 + rows_a_block)
        h0, h1 = max(0, r0 - SEED_PAD), min(m, r0 + rows_a_block + SEED_PAD)
        home = np.sort(_d2(q, qsq, r0, r1, h0, h1), axis=1)
        d_all = _d2(q, qsq, r0, r1, 0, m)
        for i, r in enumerate(range(r0, r1)):
            t = float(home[i, k]) if h1 - h0 > k else np.inf
            top = _running([(t, NONE)] * k1, d_all[i], 0)
            for o, (v, c) in enumerate(top[:k]):
                if v < BIG:
                    vals[r, o], cols[r, o] = v, c
            ties += top[k - 1][0] == top[k][0] and top[k - 1][0] < BIG
    return vals, cols, ties


def _graph_scene(seed=9, n=500):
    """``tests/test_torch_hdbscan.py``'s scene (a JAX test file)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.random(n) < 0.1] = False
    mult = rng.integers(1, 5, n).astype(np.int32)
    return pts, valid, mult


def _tie_scene():
    """A 6x6x6 lattice of 0.5 m spacing: six neighbours at exactly the
    same distance, the k-th and (k+1)-th d2 equal."""
    g = np.arange(6, dtype=np.float32) * np.float32(0.5)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return pts, np.ones(len(pts), bool)


def _scan_scene(n=2000, seed=5):
    """Rings of points in azimuth order, as a lidar sweep lists them, with
    exact duplicates: the home window holds the true neighbours of most
    rows but not of all."""
    rng = np.random.default_rng(seed)
    az = np.linspace(0.0, 2 * np.pi, n // 4, endpoint=False)
    rings = [np.stack([r * np.cos(az), r * np.sin(az), np.full_like(az, z)],
                      -1) for r, z in ((4.0, -1.5), (6.0, -1.4), (9.0, -1.2),
                                       (14.0, 0.3))]
    pts = np.concatenate(rings) + rng.normal(scale=0.02, size=(n, 3))
    pts[1::97] = pts[::97][:len(pts[1::97])]
    return pts.astype(np.float32), rng.random(n) < 0.95


def _graph_args(pts, valid, mult=None, k=7):
    """The ``_knn_graph`` arguments that ``exact_knn_mutual_reachability``
    passes for this cloud."""
    keep = []
    real = cluster._knn_graph

    def wrapped(*args):
        keep.append(args)
        return real(*args)

    cluster._knn_graph = wrapped
    try:
        cluster.exact_knn_mutual_reachability(
            torch.as_tensor(pts), torch.as_tensor(valid),
            None if mult is None else torch.as_tensor(mult), k=k)
    finally:
        cluster._knn_graph = real
    (args,) = keep
    return args


def _assert_model_equals_plain(args, what):
    q, qsq, k, block, _ = args
    stats = dict(blocks=0, tie_rows=0)
    want_v, want_c = cluster._knn_graph_plain(q, qsq, k, block, stats)
    got_v, got_c, ties = kernel_model(q.numpy(), qsq.numpy(), k)
    assert np.array_equal(got_v.view(np.int32),
                          want_v.numpy().view(np.int32)), what
    assert np.array_equal(got_c, want_c.numpy()), what
    assert ties == stats["tie_rows"], what
    return got_c, ties


@pytest.mark.parametrize("k", [3, 7, 15])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "mult"])
def test_model_equals_plain_on_the_graph_scene(weighted, k):
    pts, valid, mult = _graph_scene()
    args = _graph_args(pts, valid, mult if weighted else None, k=k)
    assert args[0].shape[0] == int(valid.sum())
    _assert_model_equals_plain(args, f"mult {weighted} k {k}")


@pytest.mark.parametrize("k", [4, 5])
def test_model_equals_plain_on_the_lattice_of_ties(k):
    pts, valid = _tie_scene()
    args = _graph_args(pts, valid, k=k)
    cols, ties = _assert_model_equals_plain(args, f"lattice k {k}")
    assert ties > 0
    # the lowest index first: lattice point 43 = (1, 1, 1) has neighbours
    # 7, 37, 42, 44, 49, 79 at 0.5 m
    assert cols[43].tolist() == [7, 37, 42, 44, 49, 79][:k]


@pytest.mark.parametrize("k", [1, 8, 20, 30])
def test_model_equals_plain_on_a_scan_ordered_cloud(k):
    """Rows in several blocks, home windows that miss some neighbours, each
    k bucket of the kernel (8, 16, 24 and 32 slots)."""
    pts, valid = _scan_scene()
    args = _graph_args(pts, valid, k=k)
    assert args[0].shape[0] > 3 * cuda_knn.BLOCK_ROWS
    _assert_model_equals_plain(args, f"scan k {k}")


@pytest.mark.parametrize("m", [1, 4, 7, 8])
def test_model_equals_plain_with_at_most_k_others(m):
    """m <= k + 1 valid points at k = 7: self and the missing slots are
    "none"; a single valid point has no neighbour."""
    pts, valid, _ = _graph_scene(seed=4, n=40)
    valid[:] = False
    valid[np.random.default_rng(m).choice(40, m, replace=False)] = True
    args = _graph_args(pts, valid)
    assert args[0].shape[0] == m
    cols, ties = _assert_model_equals_plain(args, f"m {m}")
    assert ties == 0
    assert (cols[:, m - 1:] == m).all()
    if m == 1:
        core, ed, ew = cluster.exact_knn_mutual_reachability(
            torch.as_tensor(pts), torch.as_tensor(valid), k=7)
        assert (ed.numpy() == len(pts)).all() and (ew.numpy() == BIG).all()


def _pts(m=64, **over):
    args = dict(pts=torch.zeros((m, 4)), k=20)
    args.update(over)
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(), "CUDA"),
    (dict(pts=torch.zeros((64, 4), dtype=torch.float64)), "float32"),
    (dict(pts=torch.zeros((64, 3))), "shape"),
    (dict(pts=torch.zeros((0, 4))), "shape"),
    (dict(pts=torch.zeros((64,))), "shape"),
    (dict(pts=torch.zeros((4, 64)).t()), "contiguous"),
    (dict(pts=torch.zeros((128, 4))[::2]), "contiguous"),
    (dict(k=0), "k = 0"),
    (dict(k=31), "k = 31"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """Checked before the library is loaded, so on any machine."""
    trace.clear_launches()
    with pytest.raises(ValueError, match=match):
        cuda_knn.knn_graph_cuda(**_pts(**bad))
    assert trace.launch_total() == 0


def test_cpu_graph_takes_the_plain_version():
    pts, valid, mult = _graph_scene()
    m = int(valid.sum())
    trace.clear_launches()
    info = {}
    cluster.exact_knn_mutual_reachability(
        torch.as_tensor(pts), torch.as_tensor(valid), torch.as_tensor(mult),
        k=7, info=info)
    assert trace.launch_shapes("knn_graph") == {
        ("knn_graph_plain", (m, 7)): 1}
    assert info["blocks"] == 1 and info["rows"] == m
    assert info["tie_rows"] == 0

    trace.clear()
    with trace.StageClock({}, torch.device("cpu"), "test"):
        cluster.exact_knn_mutual_reachability(
            torch.as_tensor(pts), torch.as_tensor(valid), k=7, block=4096)
    (rec,) = trace.calls()
    assert rec.counters["launches.knn_graph_plain"] == 1
    assert "launches.knn_graph" not in rec.counters
    trace.clear()


def test_gpu_kernel_bit_equal_to_the_plain_version():
    """On the card: the kernel against ``_knn_graph_plain`` on the card,
    every bit of every value and index and the tie count, on the scenes
    above and a shuffled cloud of 20,000 points;
    ``exact_knn_mutual_reachability`` launches the kernel once a call and
    the plain version never, and equals its own call through the plain
    version on the card bit for bit and the CPU's call in every edge index
    (the two devices' square roots may differ by an ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(24)
    cloud = rng.normal(scale=8.0, size=(20_000, 3)).astype(np.float32)
    cases = [("graph", *_graph_scene()[:2], 7), ("lattice", *_tie_scene(), 4),
             ("scan", *_scan_scene(), 20), ("scan k 30", *_scan_scene(), 30),
             ("shuffled", cloud, rng.random(20_000) < 0.9, 20),
             ("one point", *_graph_scene(n=1)[:2], 20)]
    for tag, pts, valid, k in cases:
        valid = valid.copy()
        valid[0] = True
        host = (torch.as_tensor(pts), torch.as_tensor(valid))
        card = tuple(a.to(dev) for a in host)
        trace.clear_launches()
        info = {}
        got = cluster.exact_knn_mutual_reachability(*card, k=k, info=info)
        m = int(valid.sum())
        assert trace.launch_shapes("knn_graph") == {
            ("knn_graph", (m, k)): 1}, tag
        assert info["blocks"] == 0, tag
        real = cluster._knn_graph
        cluster._knn_graph = lambda q, qsq, k, block, stats: (
            cluster._knn_graph_plain(q, qsq, k, block, stats))
        try:
            want = cluster.exact_knn_mutual_reachability(*card, k=k)
        finally:
            cluster._knn_graph = real
        for g, w in zip(got, want):
            assert torch.equal(g, w), tag
        host_edges = cluster.exact_knn_mutual_reachability(*host, k=k)[1]
        assert torch.equal(got[1].cpu(), host_edges), tag
        _, q, qsq = cluster.graph_points(*card)
        stats = dict(blocks=0, tie_rows=0)
        plain = cluster._knn_graph_plain(q, qsq, k, BLOCK, stats)
        pts4 = torch.cat([q, qsq[:, None]], 1)
        vals, cols, ties = cuda_knn.knn_graph_cuda(pts4, k)
        assert torch.equal(vals.view(torch.int32),
                           plain[0].view(torch.int32)), tag
        assert torch.equal(cols.long(), plain[1]), tag
        assert int(ties) == stats["tie_rows"] == info["tie_rows"], tag
