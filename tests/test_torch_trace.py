"""The port's call trace (icpflow_tpu_torch/trace.py): stage spans grown out
of StageClock, the spans and counters inside the matcher, ICP, Kabsch and
the odometry, the off path, the profiler ranges and the ring of calls.

Both entries run on the CPU at a small configuration: a frame pair through
``run_frame_pair`` and a three-scan stream through
``StreamingEngine.process`` with odometry. No JAX: the one case that needs
a GPU runs on the card with
``python3 -m pytest tests/test_torch_trace.py --noconftest -o addopts=""
-p no:cacheprovider -k gpu``.
"""

import contextlib

import numpy as np
import pytest
import torch

import icpflow_tpu_torch as T
from icpflow_tpu_torch import trace
from icpflow_tpu_torch.match import matcher
from icpflow_tpu_torch.ops import ego, knn

torch.set_num_threads(2)
CFG = T.DEMO.replace(
    max_points_scene=4096, max_points=512, num_clusters=16, max_pairs=32,
    pairs_small=32, pairs_large=4, min_cluster_size=15, nn_tile=256,
    hist_grid_xy=64, icp_max_iters=15, epsilon=0.4, speed=2.0,
    range_z=-1.8, ground_slack=0.3, ego_map_capacity=8192,
    ego_src_capacity=2048)
CAR_V = np.array([1.2, 0.2, 0.0])
EGO_V = np.array([0.7, 0.0, 0.0])
CPU = torch.device("cpu")


def _world(rng):
    def box(center, size, n):
        return center + rng.uniform(-0.5, 0.5, (n, 3)) * size
    r = np.sqrt(rng.uniform(2.0 ** 2, 35.0 ** 2, 1600))
    th = rng.uniform(0, 2 * np.pi, 1600)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       np.full(1600, -1.7) + rng.normal(scale=0.02,
                                                        size=1600)], 1)
    wall = box([0, 12, 0.0], [30, 0.3, 2.5], 1200)
    car = box([-5, -4, -0.9], [4.2, 1.8, 1.5], 600)
    parked = box([6, -6, -0.9], [4.2, 1.8, 1.5], 500)
    return ground, wall, car, parked


def _pair():
    """An ego-aligned, ground-free frame pair: the car moves."""
    rng = np.random.default_rng(3)
    _, wall, car, parked = _world(rng)
    dst = np.concatenate([wall, car, parked])
    src = np.concatenate([wall, car + CAR_V, parked])
    src = src + rng.normal(scale=0.01, size=src.shape)
    return src.astype(np.float32), dst.astype(np.float32)


def _scans():
    """Three sensor-frame scans: the car and the sensor move."""
    rng = np.random.default_rng(1)
    ground, wall, car, parked = _world(rng)
    scans = []
    for k in range(3):
        world = np.concatenate([ground, wall, car + CAR_V * k, parked])
        scan = (world - EGO_V * k) + rng.normal(scale=0.01, size=world.shape)
        scans.append(scan.astype(np.float32))
    return scans


def _run(entry, traced):
    """Every call of ``entry`` ("pair": one frame pair; "stream": three
    scans on a fresh engine): (outputs, timings dicts or Nones)."""
    outs, times = [], []
    if entry == "pair":
        eng = T.SceneFlowEngine(CFG, device="cpu")
        src, dst = _pair()
        timings = {} if traced else None
        outs.append(T.run_frame_pair(eng, src, dst, translation_frame=4.0,
                                     timings=timings))
        times.append(timings)
    else:
        stream = T.StreamingEngine(CFG, estimate_ego=True, device="cpu")
        for scan in _scans():
            timings = {} if traced else None
            outs.append(stream.process(scan, timings=timings))
            times.append(timings)
    return outs, times


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


ROOT = {"pair": "icpflow.pair", "stream": "icpflow.frame"}


@pytest.fixture(autouse=True)
def _fresh_ring():
    trace.clear()
    yield
    trace.clear()
    assert trace.current() is None


@pytest.fixture(scope="module")
def traced_runs():
    """Each entry run once traced and once untraced, and the records of
    the traced calls."""
    runs = {}
    for entry in ("pair", "stream"):
        trace.clear()
        plain = _run(entry, False)
        assert trace.calls() == []
        traced = _run(entry, True)
        runs[entry] = (plain, traced, trace.calls())
    trace.clear()
    return runs


@pytest.mark.parametrize("entry", ["pair", "stream"])
def test_untraced_call_records_nothing_and_touches_nothing(entry,
                                                          monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called on the off path")
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _run(entry, False)
    assert trace.calls() == []


@pytest.mark.parametrize("entry", ["pair", "stream"])
def test_off_path_adds_no_torch_op(entry, monkeypatch):
    """An untraced call dispatches the same aten ops, in the same order,
    as one whose trace hooks are replaced by empty functions."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def ops_of_a_run():
        with Ops() as mode:
            _run(entry, False)
        return mode.ops

    real = ops_of_a_run()
    monkeypatch.setattr(trace, "current", lambda: None)
    monkeypatch.setattr(trace, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(trace, "count", lambda name, n=1: None)
    assert ops_of_a_run() == real


def test_off_path_helpers_are_shared_no_ops():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Refuse(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            raise AssertionError(f"{func} on the off path")

    one = torch.ones(())
    with Refuse():
        assert trace.span("a") is trace.span("b")
        with trace.span("a"):
            trace.count("icp_iters", 3)
            trace.count("nn_valid.expanded.index", one)
    assert trace.current() is None and trace.calls() == []


@pytest.mark.parametrize("entry", ["pair", "stream"])
def test_outputs_are_bit_equal_with_and_without_tracing(entry, traced_runs):
    (plain, _), (traced, _), _ = traced_runs[entry]
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        _same(a, b)


@pytest.mark.parametrize("entry", ["pair", "stream"])
def test_timings_keys_are_unchanged(entry, traced_runs):
    _, (_, times), records = traced_runs[entry]
    if entry == "pair":
        assert [set(t) for t in times] == [{"cluster", "track", "flow"}]
    else:
        stages = {"ego", "ground", "cluster", "track", "flow"}
        assert [set(t) for t in times] == [{"ego", "ground"}, stages, stages]
    for t, rec in zip(times, records):
        for stage, ms in t.items():
            assert ms >= 0
            assert rec.spans["icpflow." + stage].count == 1


@pytest.mark.parametrize("entry", ["pair", "stream"])
def test_spans_nest(entry, traced_runs):
    _, (_, times), records = traced_runs[entry]
    assert len(records) == len(times)
    root = ROOT[entry]
    parents = {
        "icpflow.cluster": {root}, "icpflow.track": {root},
        "icpflow.flow": {root}, "icpflow.ego": {root},
        "icpflow.ground": {root},
        "icpflow.hist_init": {"icpflow.track"},
        "icpflow.icp": {"icpflow.track"},
        "icpflow.icp.iter": {"icpflow.icp"},
        "icpflow.kabsch": {"icpflow.icp.iter", "icpflow.ego.register"},
        "icpflow.ego.register": {"icpflow.ego"},
        root: {trace.ROOT},
    }
    seen = set()
    for rec in records:
        assert rec.entry == root.split(".", 1)[1] and rec.device == "cpu"
        assert rec.spans[root].count == 1
        children = {}
        for name, st in rec.spans.items():
            seen.add(name)
            assert set(st.parents) <= parents[name], name
            assert sum(st.parents.values()) == st.count
            assert 0 <= st.self_ns <= st.total_ns
            for p in st.parents:
                children[p] = children.get(p, 0) + st.total_ns
        for p, ns in children.items():
            if p != trace.ROOT:
                assert ns <= rec.spans[p].total_ns, p
        assert rec.end_ns >= rec.start_ns
    want = {root, "icpflow.cluster", "icpflow.track", "icpflow.flow",
            "icpflow.hist_init", "icpflow.icp", "icpflow.icp.iter",
            "icpflow.kabsch"}
    if entry == "stream":
        want |= {"icpflow.ego", "icpflow.ground", "icpflow.ego.register"}
    assert want <= seen


def _traced_with(entry, monkeypatch, obj, attr, wrapper):
    """Runs ``entry`` traced with ``obj.attr`` wrapped; returns the
    records."""
    inner = getattr(obj, attr)
    monkeypatch.setattr(obj, attr, wrapper(inner))
    _run(entry, True)
    return trace.calls()


def test_icp_iters_equal_the_points_sweeps_of_icp_core(monkeypatch):
    sweeps = [0]

    def wrap(fn):
        def counted(*a, **k):
            sweeps[0] += 1
            return fn(*a, **k)
        return counted
    (rec,) = _traced_with("pair", monkeypatch, knn, "masked_nn_points", wrap)
    assert rec.counters["icp_iters"] == sweeps[0] > 0
    assert rec.spans["icpflow.icp.iter"].count == sweeps[0]


@pytest.mark.parametrize("entry", ["pair", "stream"])
def test_nn_valid_counts_every_sweeps_candidates(entry, monkeypatch):
    """Each ``nn_valid.<form>.<output>`` equals the sum over the sweeps of
    that kind of valid src times valid dst (every dst in the sentinel
    form), counted here from the plain sweep's own inputs."""
    want = {}

    def wrap(fn):
        def counted(src, dst, dst_mask, *, form, points, tile=2048,
                    src_mask=None):
            b, n, _ = src.shape
            sv = (np.full(b, n) if src_mask is None
                  else src_mask.bool().sum(1).numpy())
            dv = (np.full(b, dst.shape[1]) if form == "sentinel"
                  else dst_mask.bool().sum(1).numpy())
            key = f"nn_valid.{form}.{'points' if points else 'index'}"
            want[key] = want.get(key, 0) + int((sv * dv).sum())
            return fn(src, dst, dst_mask, form=form, points=points,
                      tile=tile, src_mask=src_mask)
        return counted
    records = _traced_with(entry, monkeypatch, knn, "masked_nn_plain", wrap)
    got = {}
    for rec in records:
        for k, v in rec.counters.items():
            if k.startswith("nn_valid."):
                got[k] = got.get(k, 0) + v
    assert want and got == want


def test_nn_valid_under_the_sentinel_form(monkeypatch):
    monkeypatch.setenv("ICPFLOW_NN_VARIANT", "vpu2")
    src = torch.zeros((2, 5, 3))
    dst = torch.ones((2, 300, 3))
    dst_mask = torch.arange(300)[None].expand(2, 300) < torch.tensor(
        [[10], [20]])
    src_mask = torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 0, 0]]).bool()
    assert knn.valid_pairs("sentinel", src, dst_mask, src_mask).tolist() \
        == [600, 900]
    assert knn.valid_pairs("expanded", src, dst_mask, src_mask).tolist() \
        == [20, 60]
    assert knn.valid_pairs("elementwise", src, dst_mask).tolist() \
        == [50, 100]
    with T.trace.StageClock({}, CPU, "test"):
        knn.masked_nn(src, dst, dst_mask, src_mask=src_mask)
        knn.masked_nn_points(src, dst, dst_mask)
    (rec,) = trace.calls()
    assert rec.counters["nn_valid.sentinel.index"] == 1500
    assert rec.counters["nn_valid.sentinel.points"] == 3000


def test_ego_iters_count_the_odometry_host_reads(monkeypatch):
    """One host read (``ego_iters``) a registration step: every exact
    sweep of ``register_frame_icp`` but the two of its final score."""
    exact = [0]

    def wrap(fn):
        def counted(*a, **k):
            exact[0] += bool(k.get("exact"))
            return fn(*a, **k)
        return counted
    records = _traced_with("stream", monkeypatch, knn, "masked_nn", wrap)
    registers = sum(r.spans.get("icpflow.ego.register").count
                    for r in records if "icpflow.ego.register" in r.spans)
    assert registers == 4 * (len(records) - 1)     # none on the first frame
    iters = sum(r.counters["ego_iters"] for r in records)
    assert iters == exact[0] - 2 * registers > 0
    assert ego.register_frame_icp.__name__ == "register_frame_icp"


@pytest.mark.parametrize("entry", ["pair", "stream"])
def test_match_pairs_count_the_solved_pairs(entry, monkeypatch):
    solved = [0]

    def wrap(fn):
        def counted(seg_src, seg_dst, pair_src, *a, **k):
            solved[0] += pair_src.shape[0]
            return fn(seg_src, seg_dst, pair_src, *a, **k)
        return counted
    records = _traced_with(entry, monkeypatch, matcher, "_solve_bucket", wrap)
    assert sum(r.counters["match_pairs"] for r in records) == solved[0] > 0


def test_profiler_sees_the_spans_nested():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run("pair", True)
    (rec,) = trace.calls()
    assert rec.profiled
    ranges = {}
    for e in prof.events():
        if e.name.startswith("icpflow."):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    assert {n: len(r) for n, r in ranges.items()} == \
        {n: st.count for n, st in rec.spans.items()}

    def inside(child, parent):
        return all(any(p0 <= c0 and c1 <= p1 for p0, p1 in ranges[parent])
                   for c0, c1 in ranges[child])
    for child, parent in (("icpflow.track", "icpflow.pair"),
                          ("icpflow.icp", "icpflow.track"),
                          ("icpflow.icp.iter", "icpflow.icp"),
                          ("icpflow.kabsch", "icpflow.icp.iter"),
                          ("icpflow.hist_init", "icpflow.track")):
        assert inside(child, parent), child


def test_unprofiled_calls_open_no_profiler_range(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", None)
    _run("pair", True)
    (rec,) = trace.calls()
    assert not rec.profiled


def test_the_ring_keeps_the_last_calls():
    for k in range(trace.RING + 7):
        with trace.StageClock({}, CPU, "test"):
            trace.count("n", k)
    kept = trace.calls()
    assert len(kept) == trace.RING
    assert [r.counters["n"] for r in kept] == list(range(7, trace.RING + 7))
    assert [r.id for r in kept] == sorted(r.id for r in kept)
    trace.clear()
    assert trace.calls() == []


def test_inner_clocks_join_and_run_pair_alone_opens_its_own_call():
    eng = T.SceneFlowEngine(CFG, device="cpu")
    src, dst = _pair()
    p_src, v_src = eng.pad_cloud(src)
    p_dst, v_dst = eng.pad_cloud(dst)
    timings = {}
    eng.run_pair(p_src, v_src, p_dst, v_dst, 4.0, timings=timings)
    (rec,) = trace.calls()
    assert rec.entry == "pair" and set(timings) == {"cluster", "track",
                                                    "flow"}
    assert rec.spans["icpflow.track"].parents == {"icpflow.pair": 1}
    trace.clear()
    outer = {}
    with trace.StageClock(outer, CPU, "outer") as clock:
        clock.mark("a")
        inner = {}
        c2 = trace.StageClock(inner, CPU)
        c2.mark("b")
        c2.mark("end")
        c2.finish()
        clock.mark("end")
        clock.finish()
    (rec,) = trace.calls()
    assert set(outer) == {"a"} and set(inner) == {"b"}
    assert rec.spans["icpflow.b"].parents == {"icpflow.a": 1}
    assert rec.spans["icpflow.a"].parents == {"icpflow.outer": 1}


def test_a_raise_inside_a_traced_call_closes_its_trace():
    with pytest.raises(ValueError):
        with trace.StageClock({}, CPU, "test") as clock:
            clock.mark("a")
            with trace.span("inner"):
                raise ValueError("boom")
    assert trace.current() is None and trace.calls() == []
    with trace.StageClock({}, CPU, "test"):
        pass
    (rec,) = trace.calls()
    assert set(rec.spans) == {"icpflow.test"}


def test_gpu_host_syncs_count_item_and_nonzero_calls():
    """On the card: every ``.item()`` and ``nonzero`` in a traced call is
    one host sync, charged to the innermost open span; the sync mode and
    the warning filters come back as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import warnings
    dev = torch.device("cuda")
    x = torch.arange(10, device=dev)
    mode = torch.cuda.get_sync_debug_mode()
    filters = list(warnings.filters)
    with trace.StageClock({}, dev, "test"):
        x.sum().item()
        with trace.span("icpflow.a"):
            torch.nonzero(x > 3)
            x[0].item()
            with trace.span("icpflow.b"):
                torch.nonzero(x)
                y = x * 2
        y.max().item()
    (rec,) = trace.calls()
    assert dict(rec.syncs) == {"icpflow.test": 2, "icpflow.a": 2,
                               "icpflow.b": 1}
    assert rec.counters["host_syncs"] == 5
    assert torch.cuda.get_sync_debug_mode() == mode
    assert list(warnings.filters) == filters
    # an untraced call counts nothing and warns of nothing
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        x.sum().item()
    assert not seen
