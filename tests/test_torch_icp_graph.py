"""ICP's trips over a compacted working set, replayed as CUDA graphs on the
card (``icpflow_tpu_torch/ops/icp.py``).

On the CPU: ``icp_core``, which runs its one trip function eagerly there,
is bit-equal to a frozen copy of the loop it replaced (the rows gathered
every trip) over scenes whose rows freeze at different trips, with and
without the coarse phase, at B = 1, 3 and 40; the graph key holds every
constant a graph bakes in; the cache keeps its bound and drops the least
recently used entry; a traced call counts what the old loop counted and no
``icp_graph_*`` counter. No JAX: the cases that need a GPU run on the card
with ``python3 -m pytest tests/test_torch_icp_graph.py --noconftest -o
addopts="" -p no:cacheprovider -k gpu``.
"""

import collections

import numpy as np
import pytest
import torch

import icpflow_tpu_torch as T
from icpflow_tpu_torch import trace
from icpflow_tpu_torch.ops import geometry as geo
from icpflow_tpu_torch.ops import icp as ticp
from icpflow_tpu_torch.ops import knn as _knn
from icpflow_tpu_torch.ops.cuda import kabsch as cuda_kabsch
from icpflow_tpu_torch.ops.cuda import nn_kernel

_trace = trace
CPU = torch.device("cpu")
# the matcher's constants (DEMO preset)
ICP = dict(thres=0.1, max_iters=100, tile=256, patience=10, stall_rel=1e-3,
           coarse_iters=6, coarse_scale=3.0)


# The loop as it was before the working set, verbatim but for its name and
# the ``seen`` hook (the rows of each trip): the reference that the new
# loop must reproduce bit for bit.
def _loop_icp_core(src: torch.Tensor, src_mask: torch.Tensor,
                   dst: torch.Tensor, dst_mask: torch.Tensor,
                   coarse_on: bool = True, *, thres: float = 0.1,
                   max_iters: int = 100, tile: int = 1024, patience: int = 5,
                   stall_rel: float = 1e-4, corr_cap: int = 0,
                   coarse_iters: int = 0, coarse_scale: float = 3.0,
                   seen=None) -> torch.Tensor:
    b = src.shape[0]
    dev = src.device
    f32 = torch.float32
    src = src.to(f32)
    dst = dst.to(f32)
    if corr_cap and src.shape[1] > corr_cap:
        stride = -(-src.shape[1] // corr_cap)
        src = src[:, ::stride]
        src_mask = src_mask[:, ::stride]

    eff = coarse_iters if (coarse_iters and coarse_on) else 0
    eye = torch.eye(3, dtype=f32, device=dev).expand(b, 3, 3)
    R_cur = eye.clone()
    t_cur = torch.zeros((b, 3), dtype=f32, device=dev)
    best_R = eye.clone()
    best_t = torch.zeros((b, 3), dtype=f32, device=dev)
    best_rmse = torch.full((b,), float("inf"), dtype=f32, device=dev)
    stale = torch.zeros((b,), dtype=torch.int32, device=dev)
    frozen = torch.zeros((b,), dtype=torch.bool, device=dev)

    for it in range(max_iters):
        rows = torch.nonzero(~frozen)[:, 0]
        if rows.numel() == 0:
            break
        if seen is not None:
            seen.append(rows.numel())
        with _trace.span("icpflow.icp.iter"):
            _trace.count("icp_iters")
            s, sm = src[rows], src_mask[rows]
            moved = torch.einsum("bij,bnj->bni", R_cur[rows], s) \
                + t_cur[rows][:, None, :]
            nn_pts, dist = _knn.masked_nn_points(
                moved, dst[rows], dst_mask[rows], tile=tile, src_mask=sm)
            fine = it >= eff
            thr = thres if fine else thres * coarse_scale
            inlier = (dist <= thr) & sm
            R, t = geo.kabsch(s, nn_pts, inlier)
            moved2 = torch.einsum("bij,bnj->bni", R, s) + t[:, None, :]
            sq = torch.sum((moved2 - nn_pts) ** 2, dim=-1)
            w = inlier.to(f32)
            rmse = torch.sqrt(torch.sum(sq * w, 1)
                              / torch.clamp(torch.sum(w, 1), min=1e-9))

            prev = best_rmse[rows]
            first = it == eff
            if fine:
                take = torch.ones_like(rmse, dtype=torch.bool) if first \
                    else rmse < prev
                meaningful = take if first else \
                    (prev - rmse) > stall_rel * torch.clamp(prev, min=1e-20)
                st = torch.where(meaningful, torch.zeros_like(stale[rows]),
                                 stale[rows] + 1)
                tk = take[:, None]
                best_R[rows] = torch.where(tk[:, :, None], R, best_R[rows])
                best_t[rows] = torch.where(tk, t, best_t[rows])
                best_rmse[rows] = torch.where(take, rmse, prev)
            else:
                st = torch.zeros_like(stale[rows])
            stale[rows] = st
            frozen[rows] = st >= patience
            R_cur[rows] = R
            t_cur[rows] = t
    return geo.rt_to_mat(best_R, best_t)


def _scene(b, n, m, seed, device=CPU):
    """B cluster pairs: boxes of 1/4 to all of N (src) and M (dst) valid
    points, src the dst box moved by a rigid motion that grows with the
    row (yaw to 0.25 rad, 0.05-0.9 m) plus noise, so rows converge at
    different trips; where B > 8, row 1 has no valid src point and row 2
    a handful."""
    rng = np.random.default_rng(seed)
    src = np.zeros((b, n, 3), np.float32)
    dst = np.zeros((b, m, 3), np.float32)
    sm = np.zeros((b, n), bool)
    dm = np.zeros((b, m), bool)
    for i in range(b):
        size = rng.uniform([0.5, 0.5, 0.5], [4.5, 2.0, 1.8])
        center = rng.uniform(-20, 20, 3) * [1, 1, 0.05]
        nd = int(rng.integers(m // 4, m + 1))
        ns = int(rng.integers(n // 4, n + 1))
        box = center + rng.uniform(-0.5, 0.5, (nd, 3)) * size
        frac = (i + 1) / b
        yaw = rng.uniform(-0.25, 0.25) * frac
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        shift = rng.normal(size=3) * [1, 1, 0.2]
        shift *= (0.05 + 0.85 * frac) / np.linalg.norm(shift)
        pick = box[rng.integers(0, nd, ns)]
        moved = (pick - center) @ R.T + center + shift
        dst[i, :nd] = box
        dm[i, :nd] = True
        src[i, :ns] = moved + rng.normal(scale=0.01, size=moved.shape)
        sm[i, :ns] = True
    if b > 8:
        sm[1] = False
        sm[2, 5:] = False
    return tuple(torch.as_tensor(a, device=device)
                 for a in (src, sm, dst, dm))


@pytest.fixture(autouse=True)
def _fresh():
    trace.clear()
    ticp.clear_graphs()
    yield
    trace.clear()
    ticp.clear_graphs()
    assert trace.current() is None


@pytest.mark.parametrize("coarse", [True, False])
@pytest.mark.parametrize("b", [1, 3, 40])
def test_segments_bit_equal_to_the_loop(b, coarse):
    args = _scene(b, 96, 128, seed=19)
    seen = []
    want = _loop_icp_core(*args, coarse, seen=seen, **ICP)
    got = ticp.icp_core(*args, coarse, **ICP)
    assert torch.equal(got, want)
    assert got.dtype == want.dtype and got.shape == (b, 4, 4)
    if b >= 3:                               # rows froze at several trips
        assert len(set(seen)) >= 3, seen


@pytest.mark.parametrize("corr_cap,max_iters", [(64, 100), (0, 9)])
def test_strided_source_and_the_trip_cap_bit_equal_to_the_loop(corr_cap,
                                                               max_iters):
    """The strided source side (``corr_cap``) and a call that stops at
    ``max_iters`` with rows still active."""
    args = _scene(12, 200, 128, seed=5)
    kw = dict(ICP, max_iters=max_iters, corr_cap=corr_cap)
    want = _loop_icp_core(*args, True, **kw)
    assert torch.equal(ticp.icp_core(*args, True, **kw), want)


def test_apply_icp_and_an_empty_batch_bit_equal_to_the_loop(monkeypatch):
    src, sm, dst, dm = _scene(9, 64, 96, seed=2)
    init = geo.eye4(9, src)
    init[:, 0, 3] = torch.linspace(-0.3, 0.3, 9)
    got = ticp.apply_icp(src, sm, dst, dm, init, True, init_margin_rel=0.02,
                         **ICP)
    monkeypatch.setattr(ticp, "icp_core", _loop_icp_core)
    want = ticp.apply_icp(src, sm, dst, dm, init, True, init_margin_rel=0.02,
                          **ICP)
    assert torch.equal(got, want)
    empty = [a[:0] for a in (src, sm, dst, dm)]
    monkeypatch.undo()
    out = ticp.icp_core(*empty, **ICP)
    assert out.shape == (0, 4, 4)


def _work(k=4, n=8, m=256, dtype=torch.bool):
    return ticp._Work(k, n, m, dtype, dtype, CPU)


BASE = dict(phase=ticp.LATER, thres=0.1, coarse_thr=0.3, patience=10,
            stall_rel=1e-3)


@pytest.mark.parametrize("field,value", [
    ("phase", ticp.FIRST), ("phase", ticp.COARSE), ("thres", 0.2),
    ("coarse_thr", 0.4), ("patience", 11), ("stall_rel", 1e-4)])
def test_graph_key_holds_every_baked_constant(field, value):
    w = _work()
    assert ticp.graph_key(w, **BASE) == ticp.graph_key(w, **BASE)
    assert ticp.graph_key(w, **dict(BASE, **{field: value})) \
        != ticp.graph_key(w, **BASE)


@pytest.mark.parametrize("other", [dict(k=5), dict(n=9), dict(m=257),
                                   dict(dtype=torch.uint8)])
def test_graph_key_holds_the_shape_and_the_masks_dtypes(other):
    assert ticp.graph_key(_work(**other), **BASE) \
        != ticp.graph_key(_work(), **BASE)


def test_graph_key_holds_the_nn_form(monkeypatch):
    """The sweep's form is baked in: ICPFLOW_NN_VARIANT may change it
    between two calls at one shape."""
    w = _work()
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "vpu2")
    sentinel = ticp.graph_key(w, **BASE)
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "mxu")
    assert ticp.graph_key(w, **BASE) != sentinel
    assert "sentinel" in sentinel


class _NoGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_capture(made):
    def capture(work, phase, thr, patience, stall_rel, tile):
        g = ticp._Graph()
        g.graph, g.work = _NoGraph(), work
        g.nn, g.kabsch = 2, 1
        g.variants = collections.Counter({"nn_x": 2})
        g.shapes = collections.Counter({("nn_x", 1, 2, 3): 2})
        g.counted = trace.Recorded()
        g.counted.counters["kabsch_launches"] = 1
        made.append((work.src.shape[0], phase))
        return g
    return capture


def test_cache_keeps_its_bound_and_drops_the_least_recently_used(
        monkeypatch):
    made = []
    monkeypatch.setattr(ticp, "_capture", _fake_capture(made))
    monkeypatch.setattr(ticp, "GRAPH_CACHE", 3)
    works = {k: _work(k) for k in range(1, 6)}

    def replay(k, phase=ticp.LATER):
        ticp._replay(works[k], phase, 0.1, 0.3, 10, 1e-3, 8)
        assert len(ticp.graph_cache()) <= 3
        return [key[0] for key in ticp.graph_cache()]

    assert replay(1) == [1]
    assert replay(2) == [1, 2]
    assert replay(3) == [1, 2, 3]
    assert replay(1) == [2, 3, 1]            # a hit: now the newest
    assert len(made) == 3
    assert replay(4) == [3, 1, 4]            # 2 was the least recently used
    assert replay(2) == [1, 4, 2]            # 2 is captured again
    assert made == [(1, "later"), (2, "later"), (3, "later"), (4, "later"),
                    (2, "later")]
    assert replay(4, ticp.COARSE) == [4, 2, 4]   # a phase is its own key
    rng = np.random.default_rng(0)
    for k in rng.integers(1, 6, 50):
        replay(int(k))
    assert ticp.graph_cache_bytes() == sum(
        w.nbytes() for w in {id(w): w for w in
                             ticp.graph_cache().values()}.values())


def test_replays_add_the_captured_launches_and_counts(monkeypatch):
    made = []
    monkeypatch.setattr(ticp, "_capture", _fake_capture(made))
    monkeypatch.setattr(nn_kernel, "launches", 0)
    monkeypatch.setattr(nn_kernel, "variant_launches", collections.Counter())
    monkeypatch.setattr(nn_kernel, "shape_launches", collections.Counter())
    monkeypatch.setattr(cuda_kabsch, "launches", 0)
    w = _work()
    with trace.StageClock({}, CPU, "test"):
        for _ in range(3):
            ticp._replay(w, ticp.LATER, 0.1, 0.3, 10, 1e-3, 8)
    (rec,) = trace.calls()
    assert rec.counters["icp_graph_captures"] == 1
    assert rec.counters["icp_graph_replays"] == 3
    assert rec.counters["kabsch_launches"] == 3
    assert nn_kernel.launches == 6 and cuda_kabsch.launches == 3
    assert nn_kernel.variant_launches == {"nn_x": 6}
    assert nn_kernel.shape_launches == {("nn_x", 1, 2, 3): 6}


def test_recording_sets_the_call_aside_and_recount_adds_copies():
    with trace.StageClock({}, CPU, "test"):
        with trace.recording() as rec:
            with trace.span("icpflow.inner"):
                trace.count("a", 2)
                x = torch.tensor([1, 2])
                trace.count("t", x)
        x += 10                              # a replay overwrites it
        trace.recount(rec)
        x += 10
        trace.recount(rec)
    (call,) = trace.calls()
    assert "icpflow.inner" not in call.spans
    assert call.counters["a"] == 4
    assert call.counters["t"] == 11 + 12 + 21 + 22
    trace.recount(rec)                       # untraced: nothing


def _counted(fn, *args, **kw):
    trace.clear()
    with trace.StageClock({}, CPU, "test"):
        out = fn(*args, **kw)
    (rec,) = trace.calls()
    return out, rec


def test_traced_cpu_call_counts_as_the_loop():
    args = _scene(20, 96, 128, seed=3)
    want, old = _counted(_loop_icp_core, *args, True, **ICP)
    got, new = _counted(ticp.icp_core, *args, True, **ICP)
    assert torch.equal(got, want)
    assert new.counters == old.counters
    assert new.counters["icp_iters"] > 0
    assert any(k.startswith("nn_valid.") for k in new.counters)
    assert not any(k.startswith("icp_graph_") for k in new.counters)
    assert new.spans["icpflow.icp.iter"].count \
        == old.spans["icpflow.icp.iter"].count
    assert new.spans["icpflow.kabsch"].count \
        == old.spans["icpflow.kabsch"].count


def _pair():
    rng = np.random.default_rng(3)

    def box(center, size, n):
        return center + rng.uniform(-0.5, 0.5, (n, 3)) * size
    wall = box([0, 12, 0.0], [30, 0.3, 2.5], 1200)
    car = box([-5, -4, -0.9], [4.2, 1.8, 1.5], 600)
    parked = box([6, -6, -0.9], [4.2, 1.8, 1.5], 500)
    dst = np.concatenate([wall, car, parked])
    src = np.concatenate([wall, car + [1.2, 0.2, 0.0], parked])
    src = src + rng.normal(scale=0.01, size=src.shape)
    return src.astype(np.float32), dst.astype(np.float32)


def test_frame_pair_counts_and_flow_as_with_the_loop(monkeypatch):
    """A traced frame pair through the matcher: the same flow, labels and
    pairs, and the same ``icp_iters``, ``nn_valid.*`` and ``match_pairs``,
    as with the old loop."""
    cfg = T.DEMO.replace(
        max_points_scene=4096, max_points=512, num_clusters=16,
        max_pairs=32, pairs_small=32, pairs_large=4, min_cluster_size=15,
        nn_tile=256, hist_grid_xy=64, epsilon=0.4, speed=2.0)
    eng = T.SceneFlowEngine(cfg, device="cpu")
    src, dst = _pair()
    outs, recs = [], []
    for loop in (False, True):
        if loop:
            monkeypatch.setattr(ticp, "icp_core", _loop_icp_core)
        trace.clear()
        outs.append(T.run_frame_pair(eng, src, dst, translation_frame=4.0,
                                     timings={}))
        (rec,) = trace.calls()
        recs.append(rec)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    new, old = (r.counters for r in recs)
    assert new["match_pairs"] == old["match_pairs"] > 0
    assert new["icp_iters"] == old["icp_iters"] > 0
    assert {k: v for k, v in new.items() if k.startswith("nn_valid.")} \
        == {k: v for k, v in old.items() if k.startswith("nn_valid.")}


# --- on the card --------------------------------------------------------

# the main paths' shapes (B, N before corr_cap, M): the small bucket, the
# large bucket, a long-gap large bucket
GPU_SHAPES = [(40, 512, 512), (7, 4096, 4096), (3, 10000, 10000)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("variant", ["auto", "vpu2"])
def test_gpu_replay_bit_equal_to_the_eager_trip(variant, monkeypatch):
    """On the card: every trip replayed from a graph, against the old loop
    run eagerly, 0 differing bits, at the main paths' shapes, with and
    without the coarse phase, under both NN policies."""
    dev = _cuda()
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", variant)
    for i, (b, n, m) in enumerate(GPU_SHAPES):
        for coarse in (True, False):
            args = _scene(b, n, m, seed=100 + i, device=dev)
            kw = dict(ICP, corr_cap=1024)
            want = _loop_icp_core(*args, coarse, **kw)
            got = ticp.icp_core(*args, coarse, **kw)
            again = ticp.icp_core(*args, coarse, **kw)
            assert torch.equal(got, want), (b, n, m, coarse)
            assert torch.equal(again, want), (b, n, m, coarse)
    assert ticp.graph_cache()


def _launches():
    return (nn_kernel.launches, dict(nn_kernel.variant_launches),
            dict(nn_kernel.shape_launches), cuda_kabsch.launches)


def _reset(monkeypatch):
    monkeypatch.setattr(nn_kernel, "launches", 0)
    monkeypatch.setattr(nn_kernel, "variant_launches", collections.Counter())
    monkeypatch.setattr(nn_kernel, "shape_launches", collections.Counter())
    monkeypatch.setattr(cuda_kabsch, "launches", 0)


def test_gpu_traced_counts_and_launches_as_eager(monkeypatch):
    """On the card: a traced call counts the same ``icp_iters``,
    ``nn_valid.*`` and ``kabsch_launches`` as the old loop, and adds the
    same NN and Kabsch launches to the wrappers' counters; every trip is a
    replay; ``kabsch_launches`` equals the ``icpflow.kabsch`` spans plus
    the replays."""
    dev = _cuda()
    args = _scene(40, 512, 512, seed=7, device=dev)
    _reset(monkeypatch)
    _, old = _counted(_loop_icp_core, *args, True, **ICP)
    eager = _launches()
    _reset(monkeypatch)
    _, new = _counted(ticp.icp_core, *args, True, **ICP)
    assert _launches() == eager
    for key in ("icp_iters", "kabsch_launches"):
        assert new.counters[key] == old.counters[key] > 0
    assert {k: v for k, v in new.counters.items()
            if k.startswith("nn_valid.")} \
        == {k: v for k, v in old.counters.items()
            if k.startswith("nn_valid.")}
    assert new.counters["icp_graph_replays"] == new.counters["icp_iters"]
    assert 0 < new.counters["icp_graph_captures"] \
        <= new.counters["icp_graph_replays"]
    spans = new.spans.get("icpflow.kabsch")
    assert new.counters["kabsch_launches"] == \
        (spans.count if spans else 0) + new.counters["icp_graph_replays"]
    assert new.counters.get("host_syncs", 0) \
        <= old.counters.get("host_syncs", 0)


def test_gpu_second_call_makes_no_capture():
    dev = _cuda()
    args = _scene(40, 512, 512, seed=8, device=dev)
    _, first = _counted(ticp.icp_core, *args, True, **ICP)
    size = len(ticp.graph_cache())
    _, second = _counted(ticp.icp_core, *args, True, **ICP)
    assert first.counters["icp_graph_captures"] > 0
    assert second.counters.get("icp_graph_captures", 0) == 0
    assert second.counters["icp_graph_replays"] \
        == second.counters["icp_iters"] == first.counters["icp_iters"]
    assert len(ticp.graph_cache()) == size
